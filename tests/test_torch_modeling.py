"""Loading and the high-level model: ``AKI.from_pretrained`` on a port run
dir (bitwise-equal tensors), the JAX package's export imported through
``aki_torch.convert.cli`` with the tower from an HF-style SigLIP dir (logits
within 1e-5 of JAX ``aki_forward``), the checks of both readers, and
``AKI.forward`` / ``generate`` / ``answer`` against JAX ``AKIModel`` on the
same weights (aki_tiny with the hash tokenizer's layout, fp32)."""

import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aki_tpu.convert import cli as jax_cli
from aki_tpu.convert.jax_to_torch import save_torch_checkpoint
from aki_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from aki_tpu.models import configs as jax_configs
from aki_tpu.models.aki import aki_forward as jax_aki_forward
from aki_tpu.models.common import F32 as JAX_F32
from aki_tpu.models.modeling import AKIModel as JaxAKIModel
from aki_torch.convert import cli, from_jax_params
from aki_torch.data.tokenizer import HashTokenizer
from aki_torch.infer.engine import generate
from aki_torch.models.aki import AKIModel
from aki_torch.models.common import F32
from aki_torch.models.configs import aki_tiny, config_for_tokenizer
from aki_torch.models.modeling import AKI
from aki_torch.train.checkpoints import CheckpointManager
from aki_torch.train.optim import make_optimizer
from aki_torch.train.step import TrainState

from ._jax_tiny import hash_tiny_params

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)


def _png(color=(10, 200, 30), size=(64, 48)) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", size, color).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def tiny():
    """JAX weights at aki_tiny with the hash tokenizer's token layout, and
    the same weights as the port's state dict."""
    info = JaxHashTokenizer().info
    cfg_j = jax_configs.config_for_tokenizer(jax_configs.aki_tiny(info.vocab_size), info)
    cfg = config_for_tokenizer(aki_tiny(info.vocab_size), HashTokenizer().info)
    params = hash_tiny_params(11)
    rng = np.random.RandomState(12)
    ids = rng.randint(8, cfg.initial_tokenizer_len - 1, (2, 14)).astype(np.int32)
    ids[:, 1] = cfg.media_token_id
    ids[:, 9] = cfg.assistant_token_id
    valid = np.ones_like(ids)
    valid[1, 11:] = 0
    images = rng.randn(2, 28, 28, 3).astype(np.float32)
    return dict(cfg_j=cfg_j, cfg=cfg, params=params, sd=from_jax_params(params, cfg),
                ids=ids, valid=valid, images=images)


def _model(tiny) -> AKIModel:
    model = AKIModel(tiny["cfg"], device="cpu")
    model.load_state_dict(tiny["sd"], strict=True)
    return model


def _port_run_dir(tiny, path, include_frozen=True):
    model = _model(tiny)
    state = TrainState(model, make_optimizer(model, 1e-3), step=3)
    return CheckpointManager(str(path)).save(state, epoch=1, include_frozen=include_frozen)


def _jax_logits(tiny):
    out = jax_aki_forward(tiny["params"], tiny["cfg_j"], jnp.asarray(tiny["ids"]),
                          jnp.asarray(tiny["images"]), jnp.asarray(tiny["valid"]),
                          policy=JAX_F32, use_flash=False)
    return np.asarray(out.logits)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_from_pretrained_port_run_dir_is_bitwise(tiny, tmp_path, dtype):
    path = _port_run_dir(tiny, tmp_path)
    for where in (tmp_path, path):          # the run dir, and one checkpoint file
        aki = AKI.from_pretrained(str(where), tiny=True, device="cpu", dtype=dtype)
        assert aki.policy.compute_dtype == dtype
        got = aki.model.state_dict()
        assert set(got) == set(tiny["sd"])
        for k, v in tiny["sd"].items():
            assert torch.equal(got[k], v.to(dtype)), k
        assert not any(p.requires_grad for p in aki.model.parameters())


def test_from_pretrained_refuses_a_checkpoint_without_the_tower(tiny, tmp_path):
    _port_run_dir(tiny, tmp_path / "run", include_frozen=False)
    with pytest.raises(ValueError, match="vision_encoder"):
        AKI.from_pretrained(str(tmp_path / "run"), tiny=True, device="cpu")
    (tmp_path / "empty").mkdir()
    for missing in (tmp_path / "empty", tmp_path / "absent"):
        with pytest.raises(FileNotFoundError):
            AKI.from_pretrained(str(missing), tiny=True, device="cpu")
    assert not (tmp_path / "absent").exists()


def test_from_pretrained_random_weights_from_seed():
    a = AKI.from_pretrained(None, tiny=True, seed=3, device="cpu", dtype=torch.float32)
    b = AKI.from_pretrained(None, tiny=True, seed=3, device="cpu", dtype=torch.float32)
    c = AKI.from_pretrained(None, tiny=True, seed=4, device="cpu", dtype=torch.float32)
    w = lambda m: m.model.lang_model.lm_head.weight  # noqa: E731
    assert torch.equal(w(a), w(b)) and not torch.equal(w(a), w(c))
    assert a.cfg == config_for_tokenizer(aki_tiny(512), HashTokenizer().info)
    if not torch.cuda.is_available():     # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AKI.from_pretrained(None, tiny=True)


def _hf_siglip_dir(tiny, path, fmt):
    """The tower as an HF ``SiglipVisionModel`` dir, pooling head included."""
    path.mkdir()
    sd = {"vision_model." + k.removeprefix("vision_encoder."): v.contiguous()
          for k, v in tiny["sd"].items() if k.startswith("vision_encoder.")}
    sd["vision_model.head.probe"] = torch.zeros(1, 1, 32)
    sd["vision_model.head.attention.in_proj_weight"] = torch.zeros(96, 32)
    if fmt == "safetensors":
        from safetensors.torch import save_file

        save_file(sd, str(path / "model.safetensors"))
    else:
        torch.save(sd, path / "pytorch_model.bin")
    return str(path)


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_jax_export_imported_matches_jax_logits(tiny, tmp_path, fmt):
    ckpt = tmp_path / "export.pt"
    save_torch_checkpoint(tiny["params"], str(ckpt), epoch=2, step=7)
    siglip = _hf_siglip_dir(tiny, tmp_path / "siglip", fmt)
    path = cli.import_checkpoint(str(ckpt), str(tmp_path / "run"), siglip=siglip,
                                 cfg=tiny["cfg"])
    assert path.name == "checkpoint_2_7.pt"
    blob = torch.load(path, weights_only=False)
    assert set(blob["model_state_dict"]) == set(tiny["sd"])   # the head is gone
    aki = AKI.from_pretrained(str(tmp_path / "run"), tiny=True, device="cpu",
                              dtype=torch.float32)
    got = aki.forward(tiny["ids"], tiny["images"], tiny["valid"]).logits
    np.testing.assert_allclose(got.numpy(), _jax_logits(tiny), **LOGIT_TOL)


def test_import_strips_ddp_prefix_and_checks_weights(tiny, tmp_path):
    sd = {k: v for k, v in tiny["sd"].items() if not k.startswith("vision_encoder.")}
    del sd["lang_model.lm_head.bias"]          # a head bias defaults to zeros
    torch.save({"model_state_dict": {"module." + k: v for k, v in sd.items()}},
               tmp_path / "ddp.pt")
    siglip = _hf_siglip_dir(tiny, tmp_path / "siglip", "safetensors")
    path = cli.import_checkpoint(str(tmp_path / "ddp.pt"), str(tmp_path / "a"),
                                 siglip=siglip, cfg=tiny["cfg"])
    got = torch.load(path, weights_only=False)["model_state_dict"]
    assert torch.equal(got["lang_model.lm_head.bias"], torch.zeros(tiny["cfg"].phi3.vocab_size))
    assert torch.equal(got["vision_encoder.post_layernorm.weight"],
                       tiny["sd"]["vision_encoder.post_layernorm.weight"])

    def refused(sd_, match, **kw):
        torch.save({"model_state_dict": sd_}, tmp_path / "bad.pt")
        with pytest.raises(ValueError, match=match):
            cli.import_checkpoint(str(tmp_path / "bad.pt"), str(tmp_path / "b"),
                                  cfg=tiny["cfg"], **kw)

    refused({k: v for k, v in sd.items() if not k.startswith("lang_model.")}, "lang_model")
    refused(sd, "no vision encoder")
    refused({k: v for k, v in tiny["sd"].items() if k != "vision_tokenizer.latents"},
            "missing")
    refused({**tiny["sd"], "vision_tokenizer.latents": torch.zeros(3, 32)}, "another shape")


def test_rope_factors_from_config_match_jax(tiny, tmp_path, capsys):
    short, long_ = [1.0] * 8, [2.0] * 8
    (tmp_path / "config.json").write_text(json.dumps(
        {"rope_scaling": {"type": "longrope", "short_factor": short, "long_factor": long_}}))
    got = cli.rope_factors_from_config(str(tmp_path))
    assert got == jax_cli.rope_factors_from_config(str(tmp_path))
    assert got == {"rope_short_factor": tuple(short), "rope_long_factor": tuple(long_)}
    ckpt = tmp_path / "export.pt"
    save_torch_checkpoint(tiny["params"], str(ckpt))
    cfg = dataclasses.replace(tiny["cfg"], phi3=dataclasses.replace(
        tiny["cfg"].phi3, rope_short_factor=(1.5,) * 8, rope_long_factor=tuple(long_)))
    cli.import_checkpoint(str(ckpt), str(tmp_path / "run"), phi3=str(tmp_path), cfg=cfg,
                          siglip=_hf_siglip_dir(tiny, tmp_path / "siglip", "safetensors"))
    out = capsys.readouterr().out
    assert "WARNING: rope_short_factor" in out and "rope_long_factor" not in out


@pytest.fixture(scope="module")
def both(tiny):
    """JAX AKIModel and the port's AKI on the same fp32 weights."""
    aki = AKI(model=_model(tiny).requires_grad_(False), tokenizer=HashTokenizer(),
              policy=F32, max_len=96)
    jax_model = JaxAKIModel(params=jax.tree.map(jnp.asarray, tiny["params"]),
                            cfg=tiny["cfg_j"], tokenizer=JaxHashTokenizer(), policy=JAX_F32,
                            max_len=96)
    return aki, jax_model


def test_forward_and_generate_match_jax(tiny, both):
    aki, jax_model = both
    got = aki.forward(tiny["ids"], tiny["images"], tiny["valid"]).logits.numpy()
    np.testing.assert_allclose(got, _jax_logits(tiny), **LOGIT_TOL)
    toks, num = aki.generate(tiny["ids"], tiny["images"], tiny["valid"], max_new_tokens=5,
                             eos_id=aki.tokenizer.info.end_id)
    w_toks, w_num = jax_model.generate(tiny["ids"], tiny["images"], tiny["valid"],
                                       max_new_tokens=5, eos_id=aki.tokenizer.info.end_id,
                                       use_flash=False)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(w_toks))
    np.testing.assert_array_equal(num.numpy(), np.asarray(w_num))
    want, _ = generate(aki.model, tiny["ids"], tiny["images"], tiny["valid"], 5, 96,
                       eos_id=aki.tokenizer.info.end_id, policy=aki.policy, device="cpu")
    assert torch.equal(toks, want)


@pytest.mark.parametrize("color", [(10, 200, 30), (250, 250, 250)])
def test_answer_matches_jax(both, color):
    aki, jax_model = both
    data = _png(color)
    assert aki.answer(data, "what color is this ?", max_new_tokens=6) == \
        jax_model.answer(data, "what color is this ?", max_new_tokens=6)

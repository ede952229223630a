"""The port's model pieces against the JAX package at aki_tiny, fp32.

Weights move only through ``aki_torch.convert.from_jax_params``; inputs come
from a numpy seed. Tolerances: 1e-5 for single fp32 ops (the same math,
summed in another order), 1e-4 for logits after the whole stack (a few
dozen fp32 ops deep).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aki_tpu.models import configs as jax_configs
from aki_tpu.models.aki import aki_forward as jax_aki_forward
from aki_tpu.models.aki import embed_text as jax_embed_text
from aki_tpu.models.common import F32 as JAX_F32
from aki_tpu.models.fusion import collapse_logits as jax_collapse
from aki_tpu.models.fusion import splice_vision_tokens as jax_splice
from aki_tpu.models.perceiver import perceiver_forward
from aki_tpu.models.phi3 import phi3_forward
from aki_tpu.models.siglip import siglip_forward
from aki_tpu.ops.masks import MMASpec as JaxSpec
from aki_tpu.ops.masks import causal_spec as jax_causal_spec
from aki_torch.convert import from_jax_params
from aki_torch.models.aki import AKIModel, aki_forward, embed_text
from aki_torch.models.common import F32
from aki_torch.models.configs import aki_tiny
from aki_torch.models.fusion import collapse_logits, splice_vision_tokens
from aki_torch.ops.masks import MMASpec, causal_spec

from ._jax_tiny import tiny_params

OP_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def tiny():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg_j, cfg = jax_configs.aki_tiny(), aki_tiny()
    params = tiny_params(0)
    rng = np.random.RandomState(0)
    # nonzero biases and norm scales, so that every parameter shows up
    params = jax.tree.map(
        lambda a: (a + 0.05 * rng.randn(*a.shape)).astype(np.float32), params)
    model = AKIModel(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params, cfg), strict=True)
    model.requires_grad_(False)
    b, t = 3, 12
    ids = rng.randint(1, cfg.initial_tokenizer_len, (b, t)).astype(np.int32)
    ids[:, 2] = cfg.media_token_id
    ids[:, 9] = cfg.assistant_token_id
    ids[2, 2] = 5                      # row 2 has no image
    valid = np.ones((b, t), np.int32)
    valid[1, 10:] = 0                  # row 1 right-padded
    images = rng.randn(b, 28, 28, 3).astype(np.float32)
    labels = np.where(rng.rand(b, t) < 0.5, -100, ids).astype(np.int32)
    return dict(cfg_j=cfg_j, cfg=cfg, params=params, model=model, ids=ids,
                valid=valid, images=images, labels=labels, rng=rng)


def test_siglip_matches_jax(tiny):
    want = siglip_forward(tiny["params"]["siglip"], tiny["cfg_j"].siglip,
                          jnp.asarray(tiny["images"]), JAX_F32)
    with torch.no_grad():
        got = tiny["model"].vision_encoder(torch.from_numpy(tiny["images"]), F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


def test_perceiver_matches_jax(tiny):
    feats = tiny["rng"].randn(2, 4, tiny["cfg"].perceiver.dim).astype(np.float32)
    want = perceiver_forward(tiny["params"]["perceiver"], tiny["cfg_j"].perceiver,
                             jnp.asarray(feats), JAX_F32)
    with torch.no_grad():
        got = tiny["model"].vision_tokenizer(torch.from_numpy(feats), F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


def test_decoupled_embedding_clamps_like_jax(tiny):
    ids = tiny["ids"].copy()
    ids[0, 0] = 10_000                 # past both tables: clamped, not NaN
    ids[0, 1] = -3
    want = jax_embed_text(tiny["params"], tiny["cfg_j"], jnp.asarray(ids), JAX_F32)
    got = embed_text(tiny["model"], torch.from_numpy(ids), F32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **OP_TOL)


@pytest.mark.parametrize("mode", ["mma", "dot", "causal"])
def test_splice_matches_jax(tiny, mode):
    """The splice of each attention mode: MMA and the causal ablation splice
    image-first (causal then zeroes the MMA block, as the engines do), DOT
    splices text-first."""
    cfg = tiny["cfg"]
    order = "text_first" if mode == "dot" else "image_first"
    rng = np.random.RandomState(1)
    text = rng.randn(3, 12, 8).astype(np.float32)
    vis = rng.randn(3, 5, 8).astype(np.float32)
    want = jax_splice(jnp.asarray(text), jnp.asarray(vis), jnp.asarray(tiny["ids"]),
                      jnp.asarray(tiny["valid"]), cfg.media_token_id,
                      cfg.assistant_token_id, labels=jnp.asarray(tiny["labels"]),
                      order=order)
    got = splice_vision_tokens(
        torch.from_numpy(text), torch.from_numpy(vis), torch.from_numpy(tiny["ids"]),
        torch.from_numpy(tiny["valid"]), cfg.media_token_id, cfg.assistant_token_id,
        labels=torch.from_numpy(tiny["labels"]), order=order)
    if mode == "causal":
        want = dataclasses.replace(want, spec=jax_causal_spec(3))
        got = dataclasses.replace(got, spec=causal_spec(3))
    np.testing.assert_array_equal(got.embeds.numpy(), np.asarray(want.embeds))
    for field in ("attn_valid", "labels", "text_pos", "positions"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    for field in ("img_start", "txt_start", "txt_end"):
        np.testing.assert_array_equal(getattr(got.spec, field).numpy(),
                                      np.asarray(getattr(want.spec, field)), err_msg=field)
    logits = rng.randn(3, got.embeds.shape[1], 7).astype(np.float32)
    np.testing.assert_array_equal(
        collapse_logits(torch.from_numpy(logits), got.text_pos).numpy(),
        np.asarray(jax_collapse(jnp.asarray(logits), want.text_pos)))


def test_phi3_forward_matches_jax(tiny):
    cfg = tiny["cfg"]
    b, t = 2, 10
    rng = np.random.RandomState(2)
    x = rng.randn(b, t, cfg.phi3.hidden_size).astype(np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    spec = np.array([[1, 4, 8], [0, 3, 6]], np.int32)
    kv_valid = np.ones((b, t), np.int32)
    kv_valid[1, 8:] = 0
    want, _ = phi3_forward(
        tiny["params"]["phi3"], tiny["cfg_j"].phi3, jnp.asarray(x), jnp.asarray(pos),
        spec=_jax_spec(spec), kv_valid=jnp.asarray(kv_valid), policy=JAX_F32,
        use_flash=False)
    with torch.no_grad():
        got, _ = tiny["model"].lang_model.model(
            torch.from_numpy(x), torch.from_numpy(pos),
            spec=MMASpec(*(torch.from_numpy(spec[:, i]) for i in range(3))),
            kv_valid=torch.from_numpy(kv_valid), policy=F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def _jax_spec(rows):
    return JaxSpec(*(jnp.asarray(rows[:, i]) for i in range(3)))


@pytest.mark.parametrize("order", ["image_first", "text_first"])
def test_aki_forward_logits_and_loss(tiny, order):
    args = (jnp.asarray(tiny["ids"]), jnp.asarray(tiny["images"]),
            jnp.asarray(tiny["valid"]))
    want = jax_aki_forward(tiny["params"], tiny["cfg_j"], *args,
                           labels=jnp.asarray(tiny["labels"]), policy=JAX_F32,
                           use_flash=False, order=order)
    with torch.no_grad():
        got = aki_forward(tiny["model"], tiny["ids"], tiny["images"], tiny["valid"],
                          labels=tiny["labels"], policy=F32, order=order, device="cpu")
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), **LOGIT_TOL)
    np.testing.assert_allclose(got.loss.item(), float(want.loss), **LOGIT_TOL)


def test_state_dict_uses_reference_names(tiny):
    keys = set(tiny["model"].state_dict())
    for k in ("lang_model.model.layers.0.self_attn.qkv_proj.weight",
              "lang_model.model.layers.1.mlp.gate_up_proj.weight",
              "lang_model.model.embed_tokens.additional_embedding.weight",
              "lang_model.lm_head.additional_fc.bias",
              "vision_tokenizer.layers.1.1.3.weight",
              "vision_encoder.embeddings.patch_embedding.weight",
              "vision_encoder.encoder.layers.1.self_attn.out_proj.bias",
              "vision_encoder.post_layernorm.weight"):
        assert k in keys, k
    assert dataclasses.asdict(tiny["model"].cfg) == dataclasses.asdict(tiny["cfg"])

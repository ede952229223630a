"""The port's int8 quantization (``aki_torch.models.quant``) and its fused
"op + quantize" plain versions (``aki_torch.ops.fused_quant``) against the
JAX package, on the CPU.

- weights: the same int8 values and scales as JAX's ``quantize_tensor`` /
  ``quantize_params`` (w8, w8a8, fuse, vision, the fc1 128-padding), the
  port's fused qkv / gate_up against JAX's split form;
- ``mm`` on its three routes against JAX ``mm``;
- the plain fused-quant functions against JAX ``fused_quant.*`` run in
  interpret mode: int8 within one step, scales within 1e-6 relative (the
  same f32 math summed in another order);
- ``generate`` with W8A8 weights and the int8 KV cache, greedy tokens
  identical to the JAX engine's, at ``INT8_TINY``: ``aki_tiny`` with the
  widths at which every fused site runs (decoder and tower width 128,
  decoder MLP 256, tower MLP 192 padded to 256, 112-pixel images for
  64 patches per image), every site "on" in both packages, fp32 compute.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aki_tpu.convert.torch_to_jax import convert_aki_checkpoint
from aki_tpu.infer import engine as jax_engine
from aki_tpu.models import configs as jax_configs
from aki_tpu.models import quant as jax_quant
from aki_tpu.models.common import F32 as JAX_F32
from aki_tpu.ops import fused_quant as jax_fq
from aki_torch.infer import engine
from aki_torch.models import configs, quant
from aki_torch.models.aki import AKIModel
from aki_torch.models.common import F32
from aki_torch.ops import fused_quant as fq


def int8_tiny(mod):
    """``aki_tiny`` of configs module ``mod`` at widths where every fused
    site runs (see the module docstring)."""
    t = mod.aki_tiny()
    return dataclasses.replace(
        t,
        phi3=dataclasses.replace(t.phi3, hidden_size=128, intermediate_size=256,
                                 num_heads=2, num_kv_heads=2, head_dim=64),
        siglip=dataclasses.replace(t.siglip, hidden_size=128, intermediate_size=192,
                                   num_heads=2, image_size=112),
        perceiver=dataclasses.replace(t.perceiver, dim=128, dim_inner=128))


INT8_TINY, JAX_INT8_TINY = int8_tiny(configs), int8_tiny(jax_configs)
SCALE_TOL = dict(rtol=1e-7, atol=0)
# one compiled program per mode: cheaper here than eager dispatch, whose
# first call compiles every op of the tree
jax_quantize_params = jax.jit(jax_quant.quantize_params, static_argnames=("mode", "fuse", "vision"))


@pytest.fixture(scope="module")
def tiny8():
    """A port model at INT8_TINY (random init, seeded) and the same weights
    as a JAX tree, through the JAX package's own importer."""
    model = AKIModel(INT8_TINY, device="cpu", generator=torch.Generator().manual_seed(5))
    with torch.no_grad():                      # nonzero biases, so they count
        for n, p in model.named_parameters():
            if n.endswith("bias"):
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(len(n)))
    return model, convert_aki_checkpoint(model.state_dict(), JAX_INT8_TINY)


def _q(w):
    """A JAX QuantTensor in the port's layout: q (out, in), s (out,) f32."""
    return np.asarray(w.q).T, np.asarray(w.s, np.float32)[0]


def _assert_quant_equal(port: quant.QuantTensor, want_q, want_s, bias=None):
    np.testing.assert_array_equal(port.q.numpy(), want_q)
    np.testing.assert_allclose(port.s.float().numpy(), want_s, **SCALE_TOL)
    if bias is not None:
        np.testing.assert_array_equal(port.bias.numpy(), bias)


def test_quantize_tensor_matches_jax():
    rng = np.random.RandomState(0)
    w = (rng.randn(96, 40) * 0.05).astype(np.float32)       # (in, out)
    w[:, 3] = 0.0                                            # an all-zero channel
    w[5, 7] = 2.5                                            # an outlier
    want = jax_quant.quantize_tensor(jnp.asarray(w), a8=True)
    got = quant.quantize_tensor(torch.from_numpy(w.T.copy()), a8=True)
    assert got.a8 and got.q.dtype == torch.int8 and got.s.dtype == torch.bfloat16
    _assert_quant_equal(got, *_q(want))
    assert got.s[3].item() == 1.0
    with pytest.raises(ValueError):
        quant.quantize_tensor(torch.from_numpy(w.T.copy()), bits=4)


@pytest.mark.parametrize("mode,fuse,vision", [("w8", False, True), ("w8a8", False, True),
                                              ("w8a8", True, True), ("w8", True, False)])
def test_quantize_params_matches_jax(tiny8, mode, fuse, vision):
    model, params = tiny8
    want = jax_quantize_params(params, mode=mode, fuse=fuse, vision=vision)
    model = quant.quantize_params(copy.deepcopy(model), mode=mode, fuse=fuse, vision=vision)
    a8 = mode == "w8a8"
    lay = want["phi3"]["layers"]
    for i, layer in enumerate(model.lang_model.model.layers):
        att, mlp = layer.self_attn, layer.mlp
        assert att["qkv_proj"].a8 == a8
        # the port's fused projections: JAX's wqkv, or its split wq|wk|wv
        parts = [lay["wqkv"]] if fuse else [lay[k] for k in ("wq", "wk", "wv")]
        qs = [_q(jax.tree.map(lambda a: a[i], p)) for p in parts]
        _assert_quant_equal(att["qkv_proj"], np.concatenate([q for q, _ in qs]),
                            np.concatenate([s for _, s in qs]))
        parts = [lay["w_gateup"]] if fuse else [lay[k] for k in ("w_gate", "w_up")]
        qs = [_q(jax.tree.map(lambda a: a[i], p)) for p in parts]
        _assert_quant_equal(mlp["gate_up_proj"], np.concatenate([q for q, _ in qs]),
                            np.concatenate([s for _, s in qs]))
        for port_name, mod, key in (("o_proj", att, "wo"), ("down_proj", mlp, "w_down")):
            _assert_quant_equal(mod[port_name], *_q(jax.tree.map(lambda a: a[i], lay[key])))
    _assert_quant_equal(model.lang_model.lm_head.quant, *_q(want["lm_head"]["w"]))

    sly = want["siglip"]["layers"]
    for i, layer in enumerate(model.vision_encoder.encoder["layers"]):
        att, mlp = layer.self_attn, layer.mlp
        pick = lambda p: jax.tree.map(lambda a: a[i], p)  # noqa: E731
        if not vision:
            assert isinstance(att["q_proj"], torch.nn.Linear)
            assert isinstance(mlp["fc1"], torch.nn.Linear)
            continue
        if fuse:
            _assert_quant_equal(att["qkv_proj"], *_q(pick(sly["wqkv"])),
                                bias=np.asarray(sly["bqkv"][i]))
        else:
            for name, key in (("q_proj", "wq"), ("k_proj", "wk"), ("v_proj", "wv")):
                _assert_quant_equal(att[name], *_q(pick(sly[key])),
                                    bias=np.asarray(sly["b" + key[1]][i]))
        _assert_quant_equal(att["out_proj"], *_q(pick(sly["wo"])), bias=np.asarray(sly["bo"][i]))
        # fc1 192 -> 256 under a8 (zero rows, zero bias, zero fc2 columns)
        _assert_quant_equal(mlp["fc1"], *_q(pick(sly["fc1"]["w"])),
                            bias=np.asarray(sly["fc1"]["b"][i]))
        _assert_quant_equal(mlp["fc2"], *_q(pick(sly["fc2"]["w"])),
                            bias=np.asarray(sly["fc2"]["b"][i]))
        assert mlp["fc1"].q.shape[0] == (256 if a8 else 192)


@pytest.mark.parametrize("rows", [80, 8])
def test_mm_matches_jax(rows):
    """rows >= 64: the int8 x int8 route (and PreQuant); fewer: weight-only."""
    rng = np.random.RandomState(rows)
    x = rng.randn(2, rows // 2, 128).astype(np.float32)
    w = (rng.randn(128, 48) * 0.05).astype(np.float32)
    wj = jax_quant.quantize_tensor(jnp.asarray(w), a8=True)
    wt = quant.quantize_tensor(torch.from_numpy(w.T.copy()), a8=True)
    want = np.asarray(jax_quant.mm(jnp.asarray(x), wj))
    got = quant.mm(torch.from_numpy(x), wt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    qj, sj = jax_quant.quantize_acts(jnp.asarray(x))
    qt, st = quant.quantize_acts(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-7)
    pre = quant.PreQuant(q=qt, s=st, dtype=torch.float32)
    want_pre = jax_quant.mm(jax_quant.PreQuant(q=qj, s=sj, dtype=jnp.float32), wj)
    np.testing.assert_allclose(quant.mm(pre, wt).numpy(), np.asarray(want_pre), rtol=1e-6)
    with pytest.raises(TypeError):
        quant.mm(pre, quant.quantize_tensor(torch.from_numpy(w.T.copy())))


def _bf16(rng, shape):
    return np.array(jnp.asarray(rng.randn(*shape), jnp.bfloat16))


def _fused_cases():
    rng = np.random.RandomState(11)
    x = _bf16(rng, (70, 256))
    x[3] = 0                                   # an all-zero row
    x[9, 5] = 300.0                            # one huge value
    u = _bf16(rng, (70, 256))
    g = np.linspace(0.5, 2.0, 256).astype(np.float32)
    b = np.linspace(-0.3, 0.3, 256).astype(np.float32)
    return {
        "rms": (lambda m, *a: m.rmsnorm_quant(*a, 1e-5), (x, g)),
        "ln": (lambda m, *a: m.layernorm_quant(*a, 1e-6), (x, g, b)),
        "silu": (lambda m, *a: m.silu_mul_quant(*a), (x, u)),
        "gelu": (lambda m, *a: m.gelu_quant(*a), (x, b)),
    }


@pytest.mark.parametrize("site", ["rms", "ln", "silu", "gelu"])
def test_fused_quant_plain_matches_jax_kernels(site):
    fn, args = _fused_cases()[site]
    qj, sj = fn(jax_fq, *(jnp.asarray(a) for a in args))          # interpret mode
    qt, st = fn(fq, *(torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16 if a.ndim == 2 else torch.float32) for a in args))
    assert qt.dtype == torch.int8 and st.shape == (70, 1)
    diff = np.abs(qt.numpy().astype(np.int32) - np.asarray(qj, np.int32))
    assert diff.max() <= 1
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)
    assert st[3].item() == 1.0 or site in ("ln", "gelu")


def test_fused_quant_rejects_unaligned_width():
    with pytest.raises(ValueError):
        fq.rmsnorm_quant(torch.zeros(64, 250), torch.ones(250))


def test_fused_site_switch(monkeypatch):
    """auto: the composed path on CPU tensors; on: every site."""
    w = quant.quantize_tensor(torch.randn(128, 128), a8=True)
    x = torch.randn(64, 128)
    assert not quant._fusable("rms", x, w)
    assert not isinstance(quant.silu_mul_quant_acts(x, x, w), quant.PreQuant)
    monkeypatch.setattr(quant, "FUSED_ACT_QUANT", "on")
    assert isinstance(quant.norm_quant_acts("rms", torch.ones(128), None, x, 1e-5, w),
                      quant.PreQuant)
    assert not quant._fusable("rms", x[:63], w)                          # rows < 64
    assert not quant._fusable("rms", x, quant.quantize_tensor(torch.randn(128, 128)))


@pytest.fixture(scope="module")
def int8_models(tiny8):
    model, params = tiny8
    qparams = jax_quantize_params(params, mode="w8a8", fuse=False, vision=True)
    model = quant.quantize_params(copy.deepcopy(model), mode="w8a8", vision=True)
    rng = np.random.RandomState(8)
    b, t = 2, 40
    ids = rng.randint(1, INT8_TINY.initial_tokenizer_len, (b, t)).astype(np.int32)
    ids[:, 1] = INT8_TINY.media_token_id
    ids[0, 30] = ids[1, 25] = INT8_TINY.assistant_token_id
    valid = np.ones((b, t), np.int32)
    valid[1, 34:] = 0
    s = INT8_TINY.siglip.image_size
    images = rng.randn(b, s, s, 3).astype(np.float32)
    return dict(qparams=qparams, model=model, ids=ids, valid=valid, images=images)


def test_int8_generate_tokens_identical_to_jax(int8_models, monkeypatch):
    m = int8_models
    monkeypatch.setattr(jax_quant, "FUSED_ACT_QUANT", "on")
    monkeypatch.setattr(quant, "FUSED_ACT_QUANT", "on")
    calls = {f.__name__: 0 for f in fq.FUSED_QUANT_FUNCTIONS}
    for f in fq.FUSED_QUANT_FUNCTIONS:     # count the sites taken on the port side
        def counted(*a, _f=f, **kw):
            calls[_f.__name__] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(fq, f.__name__, counted)
    want_toks, want_num = jax_engine.generate(
        m["qparams"], JAX_INT8_TINY, jnp.asarray(m["ids"]), jnp.asarray(m["images"]),
        jnp.asarray(m["valid"]), max_new_tokens=6, max_len=64, policy=JAX_F32,
        use_flash=True, kv_int8=True)
    got_toks, got_num = engine.generate(m["model"], m["ids"], m["images"], m["valid"], 6, 64,
                                        policy=F32, use_flash=True, kv_int8=True,
                                        device="cpu")
    np.testing.assert_array_equal(got_toks.numpy(), np.asarray(want_toks))
    np.testing.assert_array_equal(got_num.numpy(), np.asarray(want_num))
    n_tower, n_dec = INT8_TINY.siglip.num_layers, INT8_TINY.phi3.num_layers
    assert calls == {"layernorm_quant": 2 * n_tower, "gelu_quant": n_tower,
                     "rmsnorm_quant": 2 * n_dec, "silu_mul_quant": n_dec}


@pytest.mark.parametrize("d", [128, 1152, 3072, 4352, 8192])
def test_fused_quant_row_plan_covers_every_row_once(d):
    sms = 132
    for op in fq.LANE_VALUES:
        for rows in (1, 7, 203, 264, 265, 729, 1043, 1101, 31440, 34992):
            for per_sm in (1, 3, 8):
                team, tpb, blocks = fq.row_plan(op, rows, d, sms, per_sm)
                assert team in (1, 4, 8) and tpb * team == max(team, 4)
                assert d // 4 >= 32 * team                    # a chunk for every lane
                assert d // (32 * team) <= fq.LANE_VALUES[op] or team == 8
                assert 1 <= blocks <= sms * per_sm and (blocks - 1) * tpb < rows
                teams = blocks * tpb
                seen = np.zeros(rows, np.int64)
                for t in range(teams):            # team t takes rows t, t + teams, ...
                    seen[t::teams] += 1
                assert (seen == 1).all()
    # the serving shapes: a warp a row where its registers allow, a team of
    # four at gelu's and silu*mul's widths, eight for one request's rows
    assert fq.row_plan("rms", 31440, 3072, sms, 4)[:2] == (1, 4)
    assert fq.row_plan("ln", 34992, 1152, sms, 4)[:2] == (1, 4)
    assert fq.row_plan("silu", 31440, 8192, sms, 4)[:2] == (4, 1)
    assert fq.row_plan("gelu", 34992, 4352, sms, 4)[:2] == (4, 1)
    for op, rows, d in (("rms", 203, 3072), ("silu", 1043, 8192), ("ln", 729, 1152),
                        ("gelu", 729, 4352)):
        assert fq.row_plan(op, rows, d, sms, 4)[:2] == (8, 1)
    assert fq.row_plan("rms", 7, 128, sms, 4)[:2] == (1, 4)     # one chunk a lane

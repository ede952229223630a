"""The bf16-probability prefill attention's kernel (``ops/flash_bf16p.py``,
``csrc/flash_bf16p.cu``) on the CPU: its plain mirror, its launch plan and
the routes that reach it.

- ``flash_bf16p_reference``, the kernel's arithmetic in its order (two
  passes over 64-key tiles: the row's final max, then ``p`` rounded to bf16,
  ``l`` summed over the rounded ``p``, ``acc / l``), against JAX
  ``decoder_attention_xla`` / ``encoder_attention_xla`` in fp32: MMA with a
  ragged ``kv_valid``, rows with no allowed key, GQA, head dims 72 and 96,
  keys past the queries, the non-causal tower. Both round ``p`` to bf16 from
  scores that agree to f32 rounding; exp against exp2 and the summation
  orders can flip one bf16 rounding of a ``p`` term: within 1e-5 absolute
  plus 2e-3 of the largest output, the bound of the plain route's own test;
- CPU tensors never launch the kernel: the entry points
  ``decoder_attention_bf16p`` / ``encoder_attention_bf16p`` give
  ``_bf16p_attention``'s output exactly and the counter stays;
- the launch plan mirror (``bf16p_plan``, ``bf16p_blocks``) covers every
  (64-row query tile, head, batch row) exactly once, within the card's
  shared memory, at the serving shapes and ``chip_smoke.py``'s one-request
  prefills;
- the routes: with the card faked (``attention.on_card``) a W8A8 prefill of
  a tiny model attends through the kernel's wrapper once per tower and
  decoder layer, and never through the flash forward; under ``policy=F32``
  it keeps the plain route. Under a tensor group the quantized prefill
  goes to the flash forward (``test_torch_tp.py``).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aki_tpu.ops import attention as jax_attention
from aki_tpu.ops.masks import MMASpec as JaxSpec
from aki_torch.infer import engine
from aki_torch.models import configs, phi3, quant, siglip
from aki_torch.models.aki import AKIModel
from aki_torch.models.common import F32
from aki_torch.ops import attention, flash_bf16p
from aki_torch.ops.flash_bf16p import (MAX_SMEM, SM_SMEM, bf16p_blocks, bf16p_plan,
                                       flash_bf16p_attention, flash_bf16p_reference)
from aki_torch.ops.masks import MMASpec


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=1e-5 + 2e-3 * np.abs(want).max(), rtol=0)


def _ragged(b, s):
    kv = np.ones((b, s), np.int32)
    kv[1, :3] = 0          # causal rows 0..2 of batch row 1 have no allowed key
    kv[0, 100:] = 0        # a masked tail
    return kv


# name: (b, t, s, h, hkv, d, spec rows [i0, t0, t1] per batch row or None,
#        kv_valid maker or None, q_offset, causal)
CASES = {
    "mma_ragged_d96": (2, 130, 130, 4, 4, 96, [[1, 20, 45], [3, 70, 100]], _ragged, [0, 0],
                       True),
    "mma_ragged_gqa_d72": (2, 130, 130, 4, 2, 72, [[1, 20, 45], [3, 30, 60]], _ragged,
                           [0, 0], True),
    "cache_wider_offset_d96": (2, 70, 150, 4, 1, 96, [[2, 10, 30], [0, 0, 0]], _ragged,
                               [5, 0], True),
    "tower_d72": (2, 140, 140, 3, 3, 72, None, None, [0, 0], False),
}


def _inputs(name, seed):
    b, t, s, h, hkv, d, spec, kv, q_offset, causal = CASES[name]
    rng = np.random.RandomState(seed)
    # bf16-representable values: the products are exact in f32 in both
    bf = lambda *shape: np.asarray(torch.from_numpy(  # noqa: E731
        rng.randn(*shape).astype(np.float32) * 1.5).to(torch.bfloat16).float())
    q, k, v = bf(b, t, h, d), bf(b, s, hkv, d), bf(b, s, hkv, d)
    q[0, 5, 1] = 0.0       # an all-zero q row: uniform over its keys
    spec = None if spec is None else np.asarray(spec, np.int32)
    return (q, k, v, spec, None if kv is None else kv(b, s), np.asarray(q_offset, np.int32),
            causal)


def _kw(spec, kv_valid, q_offset, arr, spec_cls):
    return dict(spec=None if spec is None else spec_cls(*(arr(spec[:, i]) for i in range(3))),
                kv_valid=None if kv_valid is None else arr(kv_valid), q_offset=arr(q_offset))


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16p_mirror_matches_jax(name):
    q, k, v, spec, kv_valid, q_offset, causal = _inputs(name, 1)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    if causal:
        want = jax.jit(jax_attention.decoder_attention_xla)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            **_kw(spec, kv_valid, q_offset, jnp.asarray, JaxSpec))
        kw = _kw(spec, kv_valid, q_offset, torch.from_numpy, MMASpec)
        got = flash_bf16p_reference(tq, tk, tv, **kw)
        entry = attention.decoder_attention_bf16p(tq, tk, tv, **kw)
    else:
        want = jax.jit(jax_attention.encoder_attention_xla)(*(jnp.asarray(x) for x in (q, k, v)))
        got = flash_bf16p_reference(tq, tk, tv, causal=False)
        entry = attention.encoder_attention_bf16p(tq, tk, tv)
    want = np.asarray(want)
    assert got.shape == tq.shape and got.dtype == torch.float32
    _close(got.numpy(), want)
    _close(got.numpy(), entry.numpy())        # the plain route, the kernel's oracle
    if kv_valid is not None:                  # rows with no allowed key are exactly 0
        assert not got[1, :3].any() and np.all(want[1, :3] == 0)


def test_bf16p_mirror_rounds_p_against_the_final_max():
    """One row, two tiles, the max in the second. The mirror rounds every p
    against the row's final max, as the JAX route does: the single-tile
    formula's result up to f32 summation order. An online softmax, which
    rounds the first tile's p against that tile's max and rescales, lands
    further off."""
    torch.manual_seed(0)
    d = 96
    q = torch.randn(1, 1, 1, d).to(torch.bfloat16).float()
    k = torch.randn(1, 128, 1, d).to(torch.bfloat16).float()
    k[0, 100] = q[0, 0] * 0.5
    v = torch.randn(1, 128, 1, d).to(torch.bfloat16).float()
    scale = torch.tensor(d ** -0.5 * flash_bf16p.LOG2E, dtype=torch.float32)
    s = torch.einsum("bthd,bshd->bhts", q, k) * scale

    def attend(p):
        return torch.einsum("bhts,bshd->bthd", p, v) / p.sum(-1)

    want = attend(torch.exp2(s - s.amax(-1, keepdim=True)).to(torch.bfloat16).float())
    m0 = s[..., :64].amax(-1, keepdim=True)
    online = torch.cat([torch.exp2(s[..., :64] - m0).to(torch.bfloat16).float()
                        * torch.exp2(m0 - s.amax(-1, keepdim=True)),
                        torch.exp2(s[..., 64:] - s.amax(-1, keepdim=True))
                        .to(torch.bfloat16).float()], dim=-1)
    got = flash_bf16p_reference(q, k, v, causal=False)
    err = lambda x: ((x - want).abs().max() / want.abs().max()).item()  # noqa: E731
    assert err(got) < 1e-6 < err(attend(online))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_never_launch(dtype):
    q, k, v, spec, kv_valid, q_offset, _ = _inputs("mma_ragged_gqa_d72", 2)
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    kw = _kw(spec, kv_valid, q_offset, torch.from_numpy, MMASpec)
    before = flash_bf16p_attention.launches
    b, t, h, d = tq.shape
    ok = attention.attention_mask(b, t, tk.shape[1], tq.device, kw["spec"], kw["kv_valid"],
                                  kw["q_offset"])
    got = attention.decoder_attention_bf16p(tq, tk, tv, **kw)
    assert torch.equal(got, attention._bf16p_attention(tq, tk, tv, ok, d ** -0.5))
    got = attention.encoder_attention_bf16p(tq, tq, tq)
    assert torch.equal(got, attention._bf16p_attention(tq, tq, tq, None, d ** -0.5))
    assert torch.equal(flash_bf16p_attention(tq, tk, tv, **kw),
                       flash_bf16p_reference(tq, tk, tv, **kw))
    assert flash_bf16p_attention.launches == before
    with pytest.raises(ValueError, match="no kernel for device"):
        m = tq.to("meta")
        flash_bf16p_attention(m, m, m)


H100_SMS = 132
# (b, t, h, causal): the serving admission and tower, chip_smoke.py's
# one-request prefills (request (a) 203 and (b) 1,043 spliced tokens), one
# image through the tower, and ragged edges
PLAN_SHAPES = {
    "decoder_serving": (48, 655, 32, True),
    "tower_serving": (48, 729, 16, False),
    "request_a": (1, 203, 32, True),
    "request_b": (1, 1043, 32, True),
    "tower_one_image": (1, 729, 16, False),
    "t_37": (2, 37, 4, True),
    "big_grid_edges": (12, 300, 32, True),
}


@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_bf16p_plan_covers_every_tile_once(name):
    """Every (64-row query tile, head, batch row) is in exactly one block;
    the blocks of one (head, batch row) are neighbours, longest KV walk
    first when causal; a block fits the card's shared memory, two 64-row
    blocks an SM."""
    b, t, h, causal = PLAN_SHAPES[name]
    plan = bf16p_plan(b, t, h, H100_SMS)
    rows = plan["rows"]
    assert rows == (192 if name.startswith(("big_grid", "decoder", "tower_serving")) else 64)
    assert plan["smem"] <= MAX_SMEM
    if rows == 64:
        assert plan["stages"] == 2 and 2 * (plan["smem"] + 1024) <= SM_SMEM
    blocks = bf16p_blocks(plan, b, t, h, causal)
    assert all(first < t for first, _, _ in blocks)
    tiles = [(first + 64 * w, hh, bb) for first, hh, bb in blocks for w in range(rows // 64)
             if first + 64 * w < t]
    want = [(r0, hh, bb) for bb in range(b) for hh in range(h) for r0 in range(0, t, 64)]
    assert sorted(tiles) == sorted(want) and len(tiles) == len(set(tiles))
    nq = -(-t // rows)
    for i in range(0, len(blocks), nq):
        group = blocks[i:i + nq]
        assert len({(hh, bb) for _, hh, bb in group}) == 1
        firsts = [first for first, _, _ in group]
        assert firsts == sorted(firsts, reverse=causal)


def _tiny_w8a8():
    t = configs.aki_tiny()
    cfg = dataclasses.replace(
        t, phi3=dataclasses.replace(t.phi3, hidden_size=128, intermediate_size=256,
                                    num_heads=2, num_kv_heads=2, head_dim=64),
        siglip=dataclasses.replace(t.siglip, hidden_size=128, intermediate_size=192,
                                   num_heads=2, image_size=112),
        perceiver=dataclasses.replace(t.perceiver, dim=128, dim_inner=128))
    model = AKIModel(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    model.requires_grad_(False)
    return cfg, quant.quantize_params(copy.deepcopy(model), mode="w8a8", vision=True)


@pytest.mark.parametrize("policy", ["bf16", "f32"])
def test_quantized_prefill_routes_to_the_kernel_on_the_card(monkeypatch, policy):
    """With the card faked, every tower and decoder layer of a W8A8 prefill
    attends through the kernel's wrapper (bf16) and none through the flash
    forward; f32 activations keep the plain route."""
    cfg, model = _tiny_w8a8()
    calls = []

    def recorded(q, k, v, *args, **kwargs):
        calls.append((tuple(q.shape), q.dtype, kwargs.get("causal", True)))
        return flash_bf16p_reference(q, k, v, *args, **kwargs)

    flash = []
    for mod in (phi3, siglip):
        real = mod.flash_mma_attention
        monkeypatch.setattr(mod, "flash_mma_attention",
                            lambda *a, _f=real, **kw: flash.append(1) or _f(*a, **kw))
    monkeypatch.setattr(attention, "on_card", lambda x: True)
    monkeypatch.setattr(siglip, "on_card", lambda x: True)
    monkeypatch.setattr(flash_bf16p, "flash_bf16p_attention", recorded)
    rng = np.random.RandomState(4)
    b, t = 2, 24
    ids = rng.randint(1, cfg.initial_tokenizer_len, (b, t)).astype(np.int32)
    ids[:, 1] = cfg.media_token_id
    ids[:, 12] = cfg.assistant_token_id
    valid = np.ones((b, t), np.int32)
    valid[1, 20:] = 0
    images = rng.randn(b, cfg.siglip.image_size, cfg.siglip.image_size, 3).astype(np.float32)
    kw = {} if policy == "bf16" else {"policy": F32}
    state = engine.prefill(model, ids, images, valid, 48, kv_int8=True, device="cpu", **kw)
    assert torch.isfinite(state.last_logits).all()
    n_tower, n_dec = cfg.siglip.num_layers, cfg.phi3.num_layers
    if policy == "f32":
        assert calls == [] and flash == []
        return
    assert not flash
    assert len(calls) == n_tower + n_dec
    assert all(dtype == torch.bfloat16 for _, dtype, _ in calls)
    assert sum(not causal for *_, causal in calls) == n_tower

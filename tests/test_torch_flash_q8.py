"""The port's int8-operand flash forward (``flash_mma_attention_q8``, its
plain version and the CPU wrapper) against the JAX wrapper with its kernel
``_kernel_1kv_q8`` in interpret mode.

- ``quantize_heads`` gives JAX ``_quantize_heads``'s int8 rows exactly and
  its scales within 1e-7 relative;
- the plain version against JAX in fp32, MMA + ``kv_valid`` and
  non-causal: both take the same int8 operands and f32 scales, so the
  scores agree bit for bit; they differ in f32 summation order and exp2's
  last bit, which can flip one bf16 rounding of a p * sv term (moving an
  output by up to 2^-8 * p * |v| / l). Tolerance 1e-3 of max|out|
  (observed ~1.2e-7 absolute at max|out| ~1.9);
- the routes JAX takes to ``flash_mma_attention`` (GQA, T or S past one
  1024 tile) are the port's too;
- the kernel's launch plan mirror (``q8_plan``, ``q8_blocks``) covers
  every (64-row query tile, head, batch row) exactly once at every shape
  of ``chip_smoke.py`` phase 13, within the card's shared memory, and the
  operands' row stride (``row_stride``, ``_padded_rows``) is one TMA can
  take.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aki_tpu.ops.flash_mma import _quantize_heads as jax_quantize_heads
from aki_tpu.ops.flash_mma import flash_mma_attention_q8 as jax_q8
from aki_tpu.ops.masks import MMASpec as JaxSpec
from aki_torch.ops.flash_mma import flash_mma_attention
from aki_torch.ops.flash_mma_q8 import (MAX_SMEM, _padded_rows, flash_mma_attention_q8,
                                        flash_mma_attention_q8_reference,
                                        flash_mma_q8_forward, flash_mma_q8_plain, q8_blocks,
                                        q8_plan, quantize_heads, quantize_operands,
                                        routes_to_flash, row_stride)
from aki_torch.ops.masks import MMASpec


def _rows(name):
    rng = np.random.RandomState(len(name))
    x = (rng.randn(2, 9, 3, 24) * 2).astype(np.float32)
    if name == "zero_rows_and_ties":
        x[0, 3, 1] = 0.0                       # scale 1, all zeros
        x[1, 2, 0] = 0.0
        x[1, 2, 0, :4] = [127.0, 2.5, -3.5, 0.5]   # s = 1: halves round to even
    return x


@pytest.mark.parametrize("name", ["f32", "bf16", "zero_rows_and_ties"])
def test_quantize_heads_matches_jax(name):
    x = _rows(name)
    if name == "bf16":
        xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    qj, sj = jax_quantize_heads(xj)
    qt, st = quantize_heads(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32 and st.shape == x.shape[:3]
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-7, atol=0)
    if name == "zero_rows_and_ties":
        assert st[0, 3, 1] == 1.0 and torch.all(qt[0, 3, 1] == 0)
        assert qt[1, 2, 0, :4].tolist() == [127, 2, -4, 0]


# name: (b, t, s, h, d, spec rows [i0, t0, t1] per batch row or None,
#        kv_valid (B, S) builder or None, q_offset, causal)
def _left_pad(b, s):
    kv = np.ones((b, s), np.int32)
    kv[1, :3] = 0          # causal rows 0..2 of batch row 1 have no allowed key
    kv[0, 60:] = 0         # a masked tail
    return kv


CASES = {
    "mma_kv_valid": (2, 70, 70, 2, 24, [[1, 20, 45], [3, 30, 60]], _left_pad, 0, True),
    "noncausal": (1, 50, 50, 2, 36, None, None, 0, False),
}


def _inputs(name, seed):
    b, t, s, h, d, spec, kv, q_offset, causal = CASES[name]
    rng = np.random.RandomState(seed)
    q = rng.randn(b, t, h, d).astype(np.float32)
    k = rng.randn(b, s, h, d).astype(np.float32)
    v = rng.randn(b, s, h, d).astype(np.float32)
    q[0, 5, 1] = 0.0       # an all-zero q row: scale 1, uniform over its keys
    spec = None if spec is None else np.asarray(spec, np.int32)
    return q, k, v, spec, None if kv is None else kv(b, s), np.asarray(q_offset, np.int32), causal


def _kw(spec, kv_valid, q_offset, causal, arr, spec_cls):
    return dict(spec=None if spec is None else spec_cls(*(arr(spec[:, i]) for i in range(3))),
                kv_valid=None if kv_valid is None else arr(kv_valid),
                q_offset=arr(q_offset), causal=causal)


@pytest.mark.parametrize("name", sorted(CASES))
def test_q8_matches_jax_interpret(name):
    q, k, v, spec, kv_valid, q_offset, causal = _inputs(name, 1)
    want = np.asarray(jax_q8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
                             **_kw(spec, kv_valid, q_offset, causal, jnp.asarray, JaxSpec)))
    kw = _kw(spec, kv_valid, q_offset, causal, torch.from_numpy, MMASpec)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    plain = flash_mma_attention_q8_reference(tq, tk, tv, **kw).numpy()
    wrapped = flash_mma_attention_q8(tq, tk, tv, **kw).numpy()
    tol = 1e-3 * np.abs(want).max()
    np.testing.assert_allclose(plain, want, rtol=0, atol=tol)
    np.testing.assert_array_equal(wrapped, plain)
    if causal:   # the rows with no allowed key are exactly 0, as in JAX
        assert np.all(want[1, :3] == 0) and np.all(wrapped[1, :3] == 0)


def test_q8_plain_on_operands_is_the_wrapper():
    """The kernel's plain version on the wrapper's own operands (what the
    card's kernel is held to) is the whole function minus the quantize."""
    q, k, v, spec, kv_valid, q_offset, causal = _inputs("mma_kv_valid", 2)
    kw = _kw(spec, kv_valid, q_offset, causal, torch.from_numpy, MMASpec)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    ops = quantize_operands(tq, tk, tv, q.shape[-1] ** -0.5)
    got = flash_mma_q8_plain(*ops, **kw, out_dtype=torch.float32)
    assert torch.equal(got, flash_mma_attention_q8(tq, tk, tv, **kw))


def test_q8_gqa_routes_like_jax():
    """GQA goes to flash_mma_attention in both packages: the port's result
    is its flash forward's, and within 2e-5 of JAX's routed result."""
    rng = np.random.RandomState(4)
    q = rng.randn(1, 48, 4, 32).astype(np.float32)
    k, v = (rng.randn(1, 48, 2, 32).astype(np.float32) for _ in range(2))
    spec = np.array([[4, 16, 30]], np.int32)
    want = np.asarray(jax_q8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
                             spec=JaxSpec(*(jnp.asarray(spec[:, i]) for i in range(3)))))
    tspec = MMASpec(*(torch.from_numpy(spec[:, i]) for i in range(3)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = flash_mma_attention_q8(tq, tk, tv, spec=tspec)
    assert torch.equal(got, flash_mma_attention(tq, tk, tv, spec=tspec))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


# (t, s, h, hkv, routed) after the JAX wrapper's rule: Hkv != H, or T or S
# rounded up to 128 (at least 128) past 1024
ROUTES = {
    "one_tile": (655, 655, 32, 32, False),
    "t_1024": (1024, 1024, 32, 32, False),
    "single_row": (1, 40, 32, 32, False),
    "t_1025": (1025, 1000, 32, 32, True),
    "s_1043": (203, 1043, 32, 32, True),
    "gqa": (150, 150, 32, 8, True),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_routes_to_flash(name):
    t, s, h, hkv, routed = ROUTES[name]
    q = torch.empty(1, t, h, 8, device="meta")
    k = torch.empty(1, s, hkv, 8, device="meta")
    assert routes_to_flash(q, k) is routed


def test_q8_cpu_tensors_never_launch():
    before = flash_mma_attention_q8.launches
    q = torch.randn(1, 8, 2, 16)
    flash_mma_attention_q8(q, q, q)
    assert flash_mma_attention_q8.launches == before
    with pytest.raises(ValueError, match="no kernel for device"):
        m = q.to("meta")
        flash_mma_attention_q8(m, m, m)


H100_SMS = 132
# chip_smoke.py phase 13's K7 shapes: (b, t, s, h, causal)
PLAN_SHAPES = {
    "decoder_serving": (48, 655, 655, 32, True),
    "tower_serving": (48, 729, 729, 16, False),
    "request_a": (1, 203, 203, 32, True),
    "zero_q_row_dead_rows": (2, 100, 100, 4, True),
    "images16_qoffset_hole_d72_h3": (2, 201, 389, 3, True),
    "images16_edges_d96": (1, 389, 389, 4, True),
    "t_37_d80": (2, 37, 37, 2, True),
    "dead_rows_d88": (2, 150, 150, 4, True),
    "big_grid_edges_d96": (12, 300, 389, 32, True),
    "big_grid_tower_hole_d72": (24, 729, 729, 16, False),
    "t_s_1024": (1, 1024, 1024, 32, True),
}


@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_q8_plan_covers_every_tile_once(name):
    """Every (64-row query tile, head, batch row) is in exactly one block;
    the blocks of one (head, batch row) are neighbours, longest KV walk
    first when causal; the plan fits the card's shared memory."""
    b, t, s, h, causal = PLAN_SHAPES[name]
    plan = q8_plan(b, t, s, h, H100_SMS)
    assert plan["smem"] <= MAX_SMEM and plan["stages"] in (2, 3)
    assert plan["rows"] == (192 if name.startswith(("big_grid", "decoder", "tower")) else 64)
    blocks = q8_blocks(plan, b, t, h, causal)
    rows = plan["rows"]
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


@pytest.mark.parametrize("h,d", [(32, 96), (16, 72), (3, 72), (1, 96), (4, 88), (2, 80)])
def test_row_stride_is_a_tma_stride(h, d):
    ld = row_stride(h, d)
    assert ld % 16 == 0 and ld >= max(h * d, 128) and ld - max(h * d, 128) < 16
    x = torch.arange(2 * 5 * h * d, dtype=torch.int64).remainder(255).sub(127).to(torch.int8)
    x = x.view(2, 5, h, d)
    rows = _padded_rows(x, ld)
    assert rows.shape == (2, 5, ld)
    assert torch.equal(rows[..., :h * d], x.reshape(2, 5, h * d))
    assert not rows[..., h * d:].any()
    if ld == h * d:
        assert rows.data_ptr() == x.data_ptr()


def test_q8_forward_refuses_past_one_tile():
    q8 = torch.zeros(1, 8, 2, 96, dtype=torch.int8)
    k8 = torch.zeros(1, 1025, 2, 96, dtype=torch.int8)
    sq, sk = torch.ones(1, 8, 2), torch.ones(1, 1025, 2)
    with pytest.raises(ValueError, match="at most 1024 keys"):
        flash_mma_q8_forward(q8, sq, k8, sk, k8, sk)

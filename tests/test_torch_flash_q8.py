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
  1024 tile) are the port's too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aki_tpu.ops.flash_mma import _quantize_heads as jax_quantize_heads
from aki_tpu.ops.flash_mma import flash_mma_attention_q8 as jax_q8
from aki_tpu.ops.masks import MMASpec as JaxSpec
from aki_torch.ops.flash_mma import flash_mma_attention
from aki_torch.ops.flash_mma_q8 import (flash_mma_attention_q8,
                                        flash_mma_attention_q8_reference,
                                        flash_mma_q8_plain, quantize_heads, quantize_operands,
                                        routes_to_flash)
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

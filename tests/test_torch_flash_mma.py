"""The port's flash MMA attention (plain version and CPU wrapper) against
the JAX kernel in interpret mode and the JAX dense oracle.

fp32 throughout. Tolerance 2e-5 absolute and relative: both sides compute
the same masked softmax in f32 and differ only in summation order and in
the JAX kernel's exp2 with log2(e) folded into q (a few f32 ulps on outputs
of magnitude ~1).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aki_tpu.ops.attention import dense_attention as jax_dense
from aki_tpu.ops.flash_mma import flash_mma_attention as jax_flash
from aki_tpu.ops.masks import MMASpec as JaxSpec
from aki_torch.ops.attention import dense_attention
from aki_torch.ops.flash_mma import (flash_mma_attention,
                                     flash_mma_attention_reference)
from aki_torch.ops.masks import MMASpec

TOL = dict(rtol=2e-5, atol=2e-5)

# name: (b, t, s, h, hkv, d, spec rows [[i0, t0, t1], ...] per batch row or
#        None, kv_valid lengths or None, q_offset, causal, JAX block size)
CASES = {
    "siglip_d72_noncausal_ragged": (1, 50, 50, 2, 2, 72, None, None, 0, False, 1024),
    "prefill_d96_mma_over_cache": (2, 40, 64, 2, 2, 96,
                                   [[[3, 13, 30]], [[0, 10, 25]]], [40, 35], 0, True, 1024),
    "two_image_union": (1, 60, 60, 2, 2, 32,
                        [[[5, 12, 20], [30, 40, 55]]], None, 0, True, 1024),
    "gqa_h4_hkv2": (1, 48, 48, 4, 2, 32, [[[4, 16, 30]]], None, 0, True, 1024),
    "q_offset": (2, 16, 48, 2, 2, 32, None, [36, 48], [20, 32], True, 1024),
    "multi_kv_tile": (1, 200, 200, 2, 2, 32, [[[10, 50, 160]]], [190], 0, True, 128),
}


def _inputs(case, seed):
    b, t, s, h, hkv, d, spec, lens, q_offset, causal, block = case
    rng = np.random.RandomState(seed)
    q = rng.randn(b, t, h, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    kv_valid = None
    if lens is not None:
        kv_valid = (np.arange(s)[None] < np.array(lens)[:, None]).astype(np.int32)
    return q, k, v, spec, kv_valid, np.asarray(q_offset, np.int32), causal, block


def _spec(rows, mod, arr):
    if rows is None:
        return None
    a = np.asarray(rows, np.int32)
    return mod(*(arr(a[:, :, i]) for i in range(3)))


def _run_both(q, k, v, spec, kv_valid, q_offset, causal, block):
    want = jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        spec=_spec(spec, JaxSpec, jnp.asarray),
        kv_valid=None if kv_valid is None else jnp.asarray(kv_valid),
        q_offset=jnp.asarray(q_offset), causal=causal, interpret=True,
        block_q=block, block_kv=block)
    kw = dict(spec=_spec(spec, MMASpec, torch.from_numpy),
              kv_valid=None if kv_valid is None else torch.from_numpy(kv_valid),
              q_offset=torch.from_numpy(q_offset), causal=causal)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    return (np.asarray(want), flash_mma_attention_reference(tq, tk, tv, **kw).numpy(),
            flash_mma_attention(tq, tk, tv, **kw).numpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_flash_interpret(name):
    q, k, v, spec, kv_valid, q_offset, causal, block = _inputs(CASES[name], 1)
    want, plain, wrapped = _run_both(q, k, v, spec, kv_valid, q_offset, causal, block)
    np.testing.assert_allclose(plain, want, **TOL)
    np.testing.assert_allclose(wrapped, want, **TOL)


@pytest.mark.parametrize("name", ["prefill_d96_mma_over_cache", "two_image_union",
                                  "gqa_h4_hkv2", "siglip_d72_noncausal_ragged"])
def test_matches_jax_dense(name):
    q, k, v, spec, kv_valid, q_offset, causal, _ = _inputs(CASES[name], 2)
    want = jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     spec=_spec(spec, JaxSpec, jnp.asarray) if causal else None,
                     kv_valid=None if kv_valid is None else jnp.asarray(kv_valid),
                     q_offset=jnp.asarray(q_offset), causal=causal)
    got = dense_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          spec=_spec(spec, MMASpec, torch.from_numpy) if causal else None,
                          kv_valid=None if kv_valid is None else torch.from_numpy(kv_valid),
                          q_offset=torch.from_numpy(q_offset), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fully_masked_rows_are_zero():
    """Left padding: keys 0..3 of row 0 invalid, so causal rows 0..3 have no
    allowed key and must give exactly 0 (not NaN), as in JAX."""
    q, k, v, *_ = _inputs((2, 64, 64, 2, 2, 32, None, None, 0, True, 1024), 3)
    kv_valid = np.ones((2, 64), np.int32)
    kv_valid[0, :4] = 0
    want, plain, wrapped = _run_both(q, k, v, None, kv_valid, np.zeros((), np.int32),
                                     True, 1024)
    assert np.all(want[0, :4] == 0.0)
    assert np.all(plain[0, :4] == 0.0) and np.all(wrapped[0, :4] == 0.0)
    np.testing.assert_allclose(wrapped, want, **TOL)


def test_decode_row_goes_to_dense():
    q, k, v, *_ = _inputs((2, 1, 64, 2, 2, 32, None, None, 0, True, 1024), 4)
    kv_valid = (np.arange(64)[None] < np.array([[40], [21]])).astype(np.int32)
    offs = np.array([39, 20], np.int32)
    want, _, wrapped = _run_both(q, k, v, None, kv_valid, offs, True, 1024)
    np.testing.assert_allclose(wrapped, want, **TOL)


def test_cpu_tensors_never_launch():
    before = flash_mma_attention.launches
    q, k, v, *_ = _inputs((1, 32, 32, 2, 2, 16, None, None, 0, True, 1024), 5)
    flash_mma_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert flash_mma_attention.launches == before == 0

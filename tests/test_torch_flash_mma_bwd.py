"""The port's flash MMA backward (plain version and the CPU autograd route)
against JAX: ``jax.grad`` through the JAX kernel's custom_vjp in interpret
mode (which runs ``run_backward``'s three Pallas kernels), and the vjp of
the JAX dense oracle.

fp32 throughout. Tolerances: 1e-5 absolute and relative against the dense
vjp (the same math in f32, summed in another order), 5e-5 against the
interpret-mode kernels (which also fold log2(e) into q and carry lse
through exp/log round trips: a few more f32 ulps on gradients of
magnitude ~1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aki_tpu.ops.attention import dense_attention as jax_dense
from aki_tpu.ops.flash_mma import flash_mma_attention as jax_flash
from aki_tpu.ops.masks import MMASpec as JaxSpec
from aki_torch.ops.flash_mma import (flash_mma_attention, flash_mma_attention_reference)
from aki_torch.ops.flash_mma_bwd import (flash_mma_backward_reference,
                                         flash_mma_lse_reference, run_backward)
from aki_torch.ops.masks import MMASpec

DENSE_TOL = dict(rtol=1e-5, atol=1e-5)
KERNEL_TOL = dict(rtol=5e-5, atol=5e-5)

# name: (b, t, s, h, hkv, d, spec rows [[i0, t0, t1], ...] per batch row or
#        None, kv_valid lengths or None, q_offset, causal)
INTERPRET_CASES = {
    "mma_right_padded": (2, 40, 40, 2, 2, 32, [[[3, 13, 30]], [[2, 12, 26]]], [40, 33], 0, True),
    "gqa_h4_hkv2_two_images": (1, 48, 48, 4, 2, 32, [[[2, 10, 20], [24, 30, 44]]], None, 0,
                               True),
    "noncausal_ragged_s": (2, 36, 52, 2, 2, 32, None, [52, 41], 0, False),
}
DENSE_CASES = {
    "q_offset": (2, 16, 48, 2, 2, 32, [[[0, 0, 0]], [[0, 0, 0]]], [36, 48], [20, 32], True),
    "head_dim_72_noncausal": (1, 30, 30, 2, 2, 72, None, [27], 0, False),
    "head_dim_96_mma": (2, 33, 33, 2, 2, 96, [[[2, 9, 20]], [[1, 8, 30]]], [33, 28], 0, True),
}


def _inputs(case, seed):
    b, t, s, h, hkv, d, spec, lens, q_offset, causal = case
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(b, t, h, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, s, hkv, d).astype(np.float32) for _ in range(2))
    kv_valid = None
    if lens is not None:
        kv_valid = (np.arange(s)[None] < np.array(lens)[:, None]).astype(np.int32)
    return q, k, v, do, spec, kv_valid, np.asarray(q_offset, np.int32), causal


def _spec(rows, mod, arr):
    if rows is None:
        return None
    a = np.asarray(rows, np.int32)
    return mod(*(arr(a[:, :, i]) for i in range(3)))


def _jax_grads(fn, q, k, v, do, spec, kv_valid, q_offset, causal):
    def loss(q_, k_, v_):
        o = fn(q_, k_, v_, spec=_spec(spec, JaxSpec, jnp.asarray),
               kv_valid=None if kv_valid is None else jnp.asarray(kv_valid),
               q_offset=jnp.asarray(q_offset), causal=causal)
        return jnp.sum(o * jnp.asarray(do))
    return [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _torch_kw(spec, kv_valid, q_offset, causal):
    return dict(spec=_spec(spec, MMASpec, torch.from_numpy),
                kv_valid=None if kv_valid is None else torch.from_numpy(kv_valid),
                q_offset=torch.from_numpy(q_offset), causal=causal)


def _port_grads(q, k, v, do, spec, kv_valid, q_offset, causal):
    """(plain backward, autograd through flash_mma_attention on the CPU)."""
    kw = _torch_kw(spec, kv_valid, q_offset, causal)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o = flash_mma_attention_reference(tq, tk, tv, **kw)
    lse = flash_mma_lse_reference(tq, tk, **kw)
    plain = flash_mma_backward_reference(tq, tk, tv, o, tdo, lse, **kw)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = flash_mma_attention(*leaves, **kw)
    auto = torch.autograd.grad(out, leaves, tdo)
    return [g.numpy() for g in plain], [g.numpy() for g in auto]


@pytest.mark.parametrize("name", sorted(INTERPRET_CASES))
def test_matches_jax_flash_backward_interpret(name):
    args = _inputs(INTERPRET_CASES[name], 1)
    want = _jax_grads(lambda *a, **kw: jax_flash(*a, interpret=True, **kw), *args)
    plain, auto = _port_grads(*args)
    for w, p, a in zip(want, plain, auto):
        np.testing.assert_allclose(p, w, **KERNEL_TOL)
        np.testing.assert_allclose(a, w, **KERNEL_TOL)


@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_matches_jax_dense_vjp(name):
    q, k, v, do, spec, kv_valid, q_offset, causal = _inputs(DENSE_CASES[name], 2)
    want = _jax_grads(lambda *a, spec=None, causal=True, **kw: jax_dense(
        *a, spec=spec if causal else None, causal=causal, **kw),
        q, k, v, do, spec, kv_valid, q_offset, causal)
    plain, auto = _port_grads(q, k, v, do, spec, kv_valid, q_offset, causal)
    for w, p, a in zip(want, plain, auto):
        np.testing.assert_allclose(p, w, **DENSE_TOL)
        np.testing.assert_allclose(a, w, **DENSE_TOL)


def test_fully_masked_rows_give_zero_dq():
    """Keys 0..3 of batch row 0 invalid: causal rows 0..3 have no allowed
    key, so their lse is +inf, their dq exactly 0, and nothing is NaN."""
    q, k, v, do, *_ = _inputs((2, 24, 24, 2, 2, 32, None, None, 0, True), 3)
    kv_valid = np.ones((2, 24), np.int32)
    kv_valid[0, :4] = 0
    args = (q, k, v, do, None, kv_valid, np.zeros((), np.int32), True)
    want = _jax_grads(jax_dense, *args)
    plain, auto = _port_grads(*args)
    lse = flash_mma_lse_reference(torch.from_numpy(q), torch.from_numpy(k),
                                  kv_valid=torch.from_numpy(kv_valid))
    assert torch.isinf(lse[0, :, :4]).all() and torch.isfinite(lse[0, :, 4:]).all()
    for grads in (plain, auto):
        assert all(np.isfinite(g).all() for g in grads)
        assert np.all(grads[0][0, :4] == 0.0)
        for w, g in zip(want, grads):
            np.testing.assert_allclose(g, w, **DENSE_TOL)


def test_gradcheck_float64():
    """torch.autograd.gradcheck of the CPU route (plain forward, plain
    backward from lse) in float64, MMA + GQA + padding at a tiny size."""
    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randn(1, 7, 2, 4)).requires_grad_()
    k = torch.from_numpy(rng.randn(1, 7, 1, 4)).requires_grad_()
    v = torch.from_numpy(rng.randn(1, 7, 1, 4)).requires_grad_()
    spec = MMASpec(*(torch.tensor([[x]], dtype=torch.int32) for x in (1, 3, 5)))
    kv_valid = torch.tensor([[1, 1, 1, 1, 1, 1, 0]], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: flash_mma_attention(q_, k_, v_, spec=spec, kv_valid=kv_valid),
        (q, k, v))


def test_cpu_tensors_never_launch():
    from aki_torch.ops.flash_mma import flash_mma_attention as f

    before = (f.launches, run_backward.dq_launches, run_backward.dkv_launches)
    q, k, v, do, *_ = _inputs((1, 16, 16, 2, 2, 72, None, None, 0, True), 5)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    torch.autograd.grad(f(*leaves), leaves, torch.from_numpy(do))
    assert before == (f.launches, run_backward.dq_launches, run_backward.dkv_launches) \
        == (0, 0, 0)
    with pytest.raises(ValueError, match="no kernel for device"):
        run_backward(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, q, do)),
                     torch.zeros(1, 2, 16))

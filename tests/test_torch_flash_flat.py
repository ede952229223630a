"""The port's flat padded-head flash forward (``flash_mma_attention_flat``,
plain version and CPU wrapper) against the JAX wrapper with its kernel
``_kernel_1kv_flat`` in interpret mode.

fp32 throughout, in the serving layout: q and k with the rope halves padded
apart within each 128-lane head, v tail-padded. Tolerance 2e-5 absolute
and relative (observed ~6e-7): both sides compute the same masked softmax
in f32 and differ only in summation order and in the JAX kernel's exp2
with scale*log2(e) folded into q.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aki_tpu.ops.flash_mma import flash_mma_attention_flat as jax_flat
from aki_tpu.ops.masks import MMASpec as JaxSpec
from aki_torch.ops.flash_mma import (flash_mma_attention, flash_mma_attention_flat,
                                     flash_mma_attention_flat_reference)
from aki_torch.ops.flash_mma_args import FLAT_HEAD_DIMS, check_kernel_inputs
from aki_torch.ops.masks import MMASpec

TOL = dict(rtol=2e-5, atol=2e-5)
DP = 128

# name: (b, t, s, h, d, spec rows [i0, t0, t1] per batch row or None,
#        kv_valid lengths or None, q_offset, causal)
CASES = {
    "decoder_mma_masked_tail": (2, 70, 70, 2, 24, [[1, 20, 45], [3, 30, 60]], [70, 50], 0,
                                True),
    "tower_noncausal_ragged": (1, 50, 50, 2, 36, None, [45], 0, False),
    "single_row": (2, 1, 40, 2, 24, None, [40, 21], [39, 20], True),
}


def _flatten_padded(x, half_aligned):
    """(B,T,H,D) -> flat (B,T,H*128) in the serving head-pad layout."""
    b, t, h, d = x.shape
    out = np.zeros((b, t, h, DP), np.float32)
    if half_aligned:   # q/k: the rope halves pad independently
        out[..., : d // 2] = x[..., : d // 2]
        out[..., DP // 2: DP // 2 + d // 2] = x[..., d // 2:]
    else:              # v: tail pad
        out[..., :d] = x
    return out.reshape(b, t, h * DP)


def _inputs(case, seed):
    b, t, s, h, d, spec, lens, q_offset, causal = case
    rng = np.random.RandomState(seed)
    q = rng.randn(b, t, h, d).astype(np.float32)
    k = rng.randn(b, s, h, d).astype(np.float32)
    v = rng.randn(b, s, h, d).astype(np.float32)
    kv_valid = None
    if lens is not None:
        kv_valid = (np.arange(s)[None] < np.array(lens)[:, None]).astype(np.int32)
    spec = None if spec is None else np.asarray(spec, np.int32)
    return q, k, v, spec, kv_valid, np.asarray(q_offset, np.int32), causal


def _kw(spec, kv_valid, q_offset, causal, arr, spec_cls):
    return dict(spec=None if spec is None else spec_cls(*(arr(spec[:, i]) for i in range(3))),
                kv_valid=None if kv_valid is None else arr(kv_valid),
                q_offset=arr(q_offset), causal=causal)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flat_matches_jax_interpret(name):
    q, k, v, spec, kv_valid, q_offset, causal = _inputs(CASES[name], 1)
    h, d = q.shape[2], q.shape[3]
    flat = [_flatten_padded(q, True), _flatten_padded(k, True), _flatten_padded(v, False)]
    want = np.asarray(jax_flat(*(jnp.asarray(x) for x in flat), num_heads=h, head_dim=d,
                               interpret=True,
                               **_kw(spec, kv_valid, q_offset, causal, jnp.asarray, JaxSpec)))
    kw = _kw(spec, kv_valid, q_offset, causal, torch.from_numpy, MMASpec)
    tq, tk, tv = (torch.from_numpy(x) for x in flat)
    plain = flash_mma_attention_flat_reference(tq, tk, tv, h, d, **kw).numpy()
    wrapped = flash_mma_attention_flat(tq, tk, tv, h, d, **kw).numpy()
    assert wrapped.shape == want.shape == flat[0].shape
    np.testing.assert_allclose(plain, want, **TOL)
    np.testing.assert_allclose(wrapped, want, **TOL)
    # the output sits in v's tail-pad layout: pad lanes exactly 0
    assert np.all(wrapped.reshape(*q.shape[:3], DP)[..., d:] == 0.0)


def test_flat_equals_flash_on_the_unpadded_view():
    """Zero pad lanes add nothing to q.k: the flat output's real lanes are
    the standard forward's on the unpadded tensors (summation order apart)."""
    q, k, v, spec, kv_valid, q_offset, causal = _inputs(CASES["decoder_mma_masked_tail"], 2)
    h, d = q.shape[2], q.shape[3]
    kw = _kw(spec, kv_valid, q_offset, causal, torch.from_numpy, MMASpec)
    flat = flash_mma_attention_flat(
        torch.from_numpy(_flatten_padded(q, True)), torch.from_numpy(_flatten_padded(k, True)),
        torch.from_numpy(_flatten_padded(v, False)), h, d, **kw)
    want = flash_mma_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               **kw)
    got = flat.reshape(*q.shape[:3], DP)
    np.testing.assert_allclose(got[..., :d].numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.all(got[..., d:] == 0)


def test_flat_fully_masked_rows_are_zero():
    """Left padding: causal rows 0..3 of batch row 0 have no allowed key and
    give exactly 0 over every lane."""
    q, k, v, *_ = _inputs((2, 40, 40, 2, 24, None, None, 0, True), 3)
    kv_valid = np.ones((2, 40), np.int32)
    kv_valid[0, :4] = 0
    out = flash_mma_attention_flat(
        torch.from_numpy(_flatten_padded(q, True)), torch.from_numpy(_flatten_padded(k, True)),
        torch.from_numpy(_flatten_padded(v, False)), 2, 24, kv_valid=torch.from_numpy(kv_valid))
    assert torch.all(out[0, :4] == 0) and torch.all(torch.isfinite(out))
    assert torch.count_nonzero(out[0, 4:]) > 0


# name: (b, t, s, last dim, num_heads)
BAD = {
    "kv_past_one_tile": (1, 16, 1025, 256, 2),
    "q_past_one_tile": (1, 1025, 16, 256, 2),
    "dp_96": (1, 16, 16, 192, 2),
    "last_dim_not_heads_times_dp": (1, 16, 16, 257, 2),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_flat_raises_as_jax(name):
    b, t, s, f, h = BAD[name]
    q, kv = np.zeros((b, t, f), np.float32), np.zeros((b, s, f), np.float32)
    with pytest.raises(ValueError):
        jax_flat(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), num_heads=h, head_dim=96,
                 interpret=True)
    with pytest.raises(ValueError):
        flash_mma_attention_flat(torch.from_numpy(q), torch.from_numpy(kv),
                                 torch.from_numpy(kv), h, 96)


def test_flat_takes_s_up_to_1024():
    """S = 1024 is one tile (no error), as in JAX; checked on the plain route."""
    q = torch.zeros(1, 4, 2 * DP)
    kv = torch.zeros(1, 1024, 2 * DP)
    assert flash_mma_attention_flat(q, kv, kv, 2, 96, causal=False).shape == q.shape


def test_width_128_is_the_forward_flat_instance_only():
    """The backward's argument check still refuses the padded width; the
    flat forward's accepts it (and then finds no card for CPU tensors)."""
    x = torch.zeros(1, 4, 2, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        check_kernel_inputs("flash_mma_bwd", x, x, x)
    with pytest.raises(ValueError, match="no kernel for device"):
        check_kernel_inputs("flash_mma_flat", x, x, x, head_dims=FLAT_HEAD_DIMS)


def test_flat_cpu_tensors_never_launch():
    before = flash_mma_attention_flat.launches
    q = torch.randn(1, 8, 2 * DP)
    flash_mma_attention_flat(q, q, q, 2, 64)
    assert flash_mma_attention_flat.launches == before
    with pytest.raises(ValueError, match="no kernel for device"):
        m = q.to("meta")
        flash_mma_attention_flat(m, m, m, 2, 64)

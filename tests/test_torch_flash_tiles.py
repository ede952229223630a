"""The forward kernel's tile classes (``flash_mma_args.tile_classes``)
against the mask they stand for.

Over random specs (1-16 images with rectangle edges at tile boundaries and
one off, ``q_offset`` > 0 with T < S, holes in ``kv_valid`` inside a tile,
non-causal calls), for every (batch row, query tile, KV tile) at the block
sizes the kernel uses:
- a *skip* tile has no allowed pair in ``masks.allowed_mask``;
- a *full* tile has every pair allowed;
- a tile holding a pair that the JAX kernel's predicate allows
  (``aki_tpu/ops/flash_mma.py:_mask_ok``, evaluated over the whole padded
  score matrix at once: it depends only on positions) is not *skip*, so
  the kernel never leaves out a tile that the JAX ``_kernel`` computes
  with an allowed pair.
Exact integer and boolean comparisons: no tolerance.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aki_tpu.ops.flash_mma import _mask_ok
from aki_torch.ops.flash_mma_args import (FULL, PARTIAL, SKIP, TILE_CLASS_NAMES,
                                          tile_classes)
from aki_torch.ops.masks import MMASpec, allowed_mask

# (query rows, keys) per tile: a consumer warpgroup, a 192-row block, a
# 128-row block (width 128), all over 64-key tiles
BLOCKS = ((64, 64), (192, 64), (128, 64))
SEEDS = range(12)


def _near(rng, block, hi):
    """A position at a tile boundary or one off it, in [0, hi]."""
    return int(np.clip(rng.randint(0, hi // block + 2) * block + rng.choice([-1, 0, 1]), 0, hi))


def _case(seed):
    """One random call: (spec or None, kv_valid (B, S) int32 or None,
    q_offset (B,) int64, T, S, causal)."""
    rng = np.random.RandomState(seed)
    b = rng.randint(1, 4)
    s = rng.randint(1, 7) * 64 + int(rng.choice([-1, 0, 1, 37]))
    if rng.rand() < 0.5:
        t = rng.randint(1, s + 1)
        q_offset = rng.randint(0, s - t + 1, size=b)
    else:
        t, q_offset = s, np.zeros(b, np.int64)
    causal = rng.rand() < 0.8
    n_img = rng.randint(1, 17)
    rows = []
    for _ in range(b):
        rects = []
        for _ in range(n_img):
            i0, t0, t1 = sorted(_near(rng, 64, s) for _ in range(3))
            rects.append((i0, t0, t1))
        rows.append(rects)
    coords = np.asarray(rows, np.int32)                      # (B, N, 3)
    spec = MMASpec(*(torch.from_numpy(coords[:, :, i].copy()) for i in range(3)))
    kv_valid = None
    if rng.rand() < 0.75:
        lens = rng.randint(0, s + 1, size=b)
        valid = (np.arange(s)[None] < lens[:, None]).astype(np.int32)
        for row in range(b):                                 # holes inside tiles
            for _ in range(rng.randint(0, 4)):
                valid[row, rng.randint(0, s)] = 0
        kv_valid = torch.from_numpy(valid)
    return spec, kv_valid, torch.from_numpy(q_offset.astype(np.int64)), t, s, causal


def _torch_allowed(spec, kv_valid, q_offset, t, s, causal):
    """(B, T, S) pairs the kernel's predicate allows (non-causal: kv_valid only)."""
    b = spec.batch
    if causal:
        return allowed_mask(spec, t, s, kv_valid, q_offset)
    keys = torch.ones(b, s, dtype=torch.bool) if kv_valid is None else kv_valid != 0
    return keys[:, None, :].expand(b, t, s)


@functools.lru_cache(maxsize=None)
def _jax_allowed(seed):
    """(B, T, S) pairs allowed by the JAX kernel's ``_mask_ok`` for
    ``_case(seed)``, over one padded tile per batch row (rows to a multiple
    of every block's rows, keys past S invalid, as its wrapper pads them),
    cut to the real rows and keys."""
    spec, kv_valid, q_offset, t, s, causal = _case(seed)
    tp, sp = -(-t // 384) * 384, -(-s // 64) * 64
    i0, t0, t1 = (jnp.asarray(x.numpy()) for x in (spec.img_start, spec.txt_start,
                                                     spec.txt_end))
    valid = np.zeros((spec.batch, sp), np.int32)
    valid[:, :s] = 1 if kv_valid is None else kv_valid.numpy()
    out = []
    for row in range(spec.batch):
        ok = _mask_ok(i0, t0, t1, jnp.asarray(valid[row][None, None]), row,
                      int(q_offset[row]), 0, tp, sp, i0.shape[1] if causal else 0, causal)
        out.append(np.asarray(ok)[:t, :s])
    return np.stack(out)


def _tiles(x, bm, bn):
    """(B, nq*bm, nk*bn) -> (B, nq, nk, bm, bn)."""
    b, tp, sp = x.shape
    return x.reshape(b, tp // bm, bm, sp // bn, bn).transpose(0, 1, 3, 2, 4)


@pytest.mark.parametrize("bm,bn", BLOCKS)
@pytest.mark.parametrize("seed", SEEDS)
def test_classes_hold_for_random_specs(seed, bm, bn):
    spec, kv_valid, q_offset, t, s, causal = _case(seed)
    cls = tile_classes(spec, kv_valid, q_offset, t, s, causal, bm, bn).numpy()
    nq, nk = cls.shape[1:]
    tp, sp = nq * bm, nk * bn
    allowed = _torch_allowed(spec, kv_valid, q_offset, t, s, causal).numpy()
    jax_ok = _jax_allowed(seed)
    np.testing.assert_array_equal(jax_ok, allowed)   # the two predicates agree
    # keys past S are never allowed; rows past T do not exist
    pairs = np.pad(allowed, ((0, 0), (0, tp - t), (0, sp - s)))
    real = pairs.copy()
    real[:, t:, :] = True
    any_pair = _tiles(pairs, bm, bn).any((-1, -2))
    every_pair = _tiles(real, bm, bn).all((-1, -2))
    assert set(np.unique(cls)) <= {SKIP, FULL, PARTIAL}
    assert not (any_pair & (cls == SKIP)).any(), "a skip tile holds an allowed pair"
    assert (every_pair | (cls != FULL)).all(), "a full tile holds a masked pair"
    jax_pair = _tiles(np.pad(jax_ok, ((0, 0), (0, tp - t), (0, sp - s))), bm, bn).any((-1, -2))
    assert not (jax_pair & (cls == SKIP)).any(), "a tile the JAX kernel computes is skipped"


def test_classes_of_a_prefill():
    """One prompt's prefill over a longer cache, by hand: <image> rows 2..145
    see the question keys 146..179; 203 real tokens of a 300-slot cache."""
    spec = MMASpec(torch.tensor([[2]]), torch.tensor([[146]]), torch.tensor([[180]]))
    kv_valid = (torch.arange(300) < 203).to(torch.int32)[None]
    got = tile_classes(spec, kv_valid, 0, 203, 300, True)
    want = [[2, 0, 2, 0, 0],       # rows 0-63: diagonal, then the rectangle's keys
            [1, 2, 2, 0, 0],
            [1, 1, 2, 0, 0],
            [1, 1, 1, 2, 0]]       # rows 192-202: keys 192-255 hold 203..255 invalid
    assert got.tolist() == [want]
    assert [TILE_CLASS_NAMES[c] for c in want[0]] == ["partial", "skip", "partial",
                                                      "skip", "skip"]


def test_non_causal_is_never_skip():
    """The tower: no frontier and no rectangles; a ragged last tile or a
    kv_valid hole makes a tile partial."""
    kv_valid = torch.ones(2, 129, dtype=torch.int32)
    kv_valid[1, 70] = 0
    got = tile_classes(None, kv_valid, 0, 100, 129, False)
    assert got.shape == (2, 2, 3)
    assert got[0].tolist() == [[1, 1, 2], [1, 1, 2]]
    assert got[1].tolist() == [[1, 2, 2], [1, 2, 2]]


def test_batch_and_offset_broadcast():
    """B from q_offset when there is no spec or kv_valid; a scalar offset."""
    per_row = tile_classes(None, None, torch.tensor([0, 128]), 64, 256, True)
    assert per_row.shape == (2, 1, 4)
    assert per_row[0, 0].tolist() == [2, 0, 0, 0]
    assert per_row[1, 0].tolist() == [1, 1, 2, 0]
    assert tile_classes(None, None, 128, 64, 256, True).tolist() == [per_row[1].tolist()]

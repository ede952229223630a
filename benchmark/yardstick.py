"""The benchmark's own yardstick: the chip's peaks, the arithmetic that
turns shapes into operations and bytes, and the rows of the training mix.

The roofline arithmetic (``allowed_work``, ``backward_work``, ``bound_s``,
``fused_quant_work``) is a frozen copy of what ``chip_smoke.py`` held (each
function names the line it was copied from); the row generators are the
benchmark's own. The benchmark owns all of it, so that a change to the
program cannot move the measure it is held to. Plain Python, NumPy and
PyTorch only.
"""

from __future__ import annotations

import numpy as np
import torch

# Published dense peaks of one NVIDIA H100 SXM (data sheet, no sparsity)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# chip_smoke.py:282, operations per value of each fused "op + quantize"
QUANT_OPS_PER_VALUE = {"rms": 10, "ln": 12, "silu": 11, "gelu": 16}


def allowed_work(b, t, s, h, hkv, d, allowed, has_valid):
    """``chip_smoke.py:537 allowed_work``: FLOPs and bytes that the masked
    attention itself needs, whatever the kernel's tiling: 4*d FLOPs per
    head and allowed (query row, key) pair (QK^T and PV); q read and out
    written once; K, V (and kv_valid, when given) read once for each key
    that some row may attend. ``allowed`` is the (B, T, S) bool mask, None
    for all pairs."""
    if allowed is None:
        pairs, keys = b * t * s, b * s
    else:
        pairs, keys = int(allowed.sum()), int(allowed.any(dim=1).sum())
    nbytes = 2 * (2 * b * t * h * d) + keys * (2 * 2 * hkv * d + 4 * has_valid)
    return 4 * d * h * pairs, nbytes


def backward_work(b, t, s, h, hkv, d, allowed):
    """``chip_smoke.py:868 backward_work``: (FLOPs, bytes) of the attention
    backward for (dq kernel, dkv kernel, both). dq does S, dP, dQ (6d a
    pair) and reads q, dO, lse, K, V and writes dq; dkv does S, dP, dV, dK
    (8d) and reads q, dO, lse, K, V and writes dk, dv."""
    pairs, keys = int(allowed.sum()), int(allowed.any(dim=1).sum())
    qb = 2 * b * t * h * d
    kvb = 2 * b * s * hkv * d
    kv_read = keys * (2 * 2 * hkv * d + 4)
    lse_b = 4 * b * h * t
    both = (10 * d * h * pairs, 4 * qb + lse_b + kv_read + 2 * kvb)
    dq = (6 * d * h * pairs, 3 * qb + lse_b + kv_read)
    dkv = (8 * d * h * pairs, 2 * qb + lse_b + kv_read + 2 * kvb)
    return dq, dkv, both


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the chip could take: the larger of the operations over
    their peak and the bytes over HBM's (``chip_smoke.py:888 bound``)."""
    return max(flops / peak_flops, nbytes / PEAK_HBM_BYTES)


def fused_quant_work(op: str, rows: int, d: int, row_bytes: int = 2) -> tuple[int, int]:
    """``chip_smoke.py:1580 fused_quant_bound``: (FLOPs, bytes) of one fused
    quantize launch: each input row and vector read once, q and s written
    once."""
    n_vec = {"rms": 1, "ln": 2, "silu": 0, "gelu": 1}[op]
    n_rows_in = 2 if op == "silu" else 1
    nbytes = rows * d * row_bytes * n_rows_in + n_vec * d * 2 + rows * d + rows * 4
    return QUANT_OPS_PER_VALUE[op] * rows * d, nbytes


def valid_spliced_tokens(input_ids: torch.Tensor, attn_valid: torch.Tensor, media_id: int,
                         n_vis: int, max_images: int) -> int:
    """Valid spliced tokens of one batch: the text with ``attn_valid`` plus
    ``n_vis - 1`` for each image present (its ``<image>`` token is among
    the text), at most ``max_images`` a row."""
    valid = attn_valid != 0
    n_img = ((input_ids == media_id) & valid).sum(dim=1).clamp(max=max_images)
    return int(valid.sum()) + int(n_img.sum()) * (n_vis - 1)


def train_rows_paired(rng: np.random.RandomState, gen: torch.Generator, n_rows: int,
                      text_len: int, caption_lens: list[int], ids: dict, image_size: int,
                      device) -> dict:
    """One caption batch in the pretrain loader's format (``[bos] <image>
    caption <|endofchunk|> [eos]``, right-padded to ``text_len``, labels on
    every valid token, images in [-1, 1]); row r holds ``caption_lens[r]``
    valid tokens. ``ids`` holds the special ids and the ``text`` id range.
    Token ids from ``rng``, on the host (int32 arrays, as the loader gives
    them); pixels from ``gen`` on ``device``."""
    input_ids = np.full((n_rows, text_len), ids["pad"], np.int32)
    valid = np.zeros((n_rows, text_len), np.int32)
    for r, n in enumerate(caption_lens):
        body = rng.randint(*ids["text"], size=n - 4)
        input_ids[r, :n] = np.concatenate([[ids["bos"], ids["media"]], body,
                                           [ids["eoc"], ids["eos"]]])
        valid[r, :n] = 1
    labels = np.where(valid == 1, input_ids, -100).astype(np.int32)
    images = torch.rand(n_rows, image_size, image_size, 3, generator=gen, device=device) * 2 - 1
    return dict(input_ids=input_ids, attn_valid=valid, labels=labels, images=images)


def interleaved_layout(rng: np.random.RandomState, n: int, n_img: int) -> tuple[int, list[int]]:
    """(valid tokens, places of the ``<image>`` tokens) of one interleaved
    row: ``n_img`` distinct even places after ``[bos]``, 2 apart at least
    (each image a chunk "<|endofchunk|><image>")."""
    starts = np.sort(rng.choice(np.arange(1, (n - 2) // 2), size=n_img, replace=False)) * 2
    return n, [int(x) for x in starts]


def train_rows_interleaved(rng: np.random.RandomState, gen: torch.Generator, text_len: int,
                           max_images: int, layouts: list[tuple[int, list[int]]], ids: dict,
                           image_size: int, device) -> dict:
    """One interleaved batch in the MMC4 loader's format: row r has
    ``layouts[r] = (valid tokens, image places)``, an ``<|endofchunk|>``
    before each image but the first, ``[bos]`` first and ``[eos]`` last;
    right-padded to ``text_len``; labels on every valid token; the
    ``max_images`` image slots filled in order, the missing ones zero, the
    others in [-1, 1]; host arrays and device pixels as for captions."""
    n_rows = len(layouts)
    input_ids = np.full((n_rows, text_len), ids["pad"], np.int32)
    valid = np.zeros((n_rows, text_len), np.int32)
    images = torch.rand(n_rows, max_images, image_size, image_size, 3, generator=gen,
                        device=device) * 2 - 1
    for r, (n, starts) in enumerate(layouts):
        row = rng.randint(*ids["text"], size=n)
        row[0], row[n - 1] = ids["bos"], ids["eos"]
        for j, s in enumerate(starts):
            row[s] = ids["media"]
            if j:
                row[s - 1] = ids["eoc"]
        input_ids[r, :n] = row
        valid[r, :n] = 1
        images[r, len(starts):] = 0
    labels = np.where(valid == 1, input_ids, -100).astype(np.int32)
    return dict(input_ids=input_ids, attn_valid=valid, labels=labels, images=images)


def attention_masks(rows: dict, model: dict) -> torch.Tensor:
    """The decoder's (B, T_full, T_full) attention mask of one batch (host
    ``input_ids`` and ``attn_valid``, ``slots`` image slots a row): a valid
    key at or before the query, or in an image's MMA block, as the plain
    reference splices the row."""
    from benchmark.reference.aki_plain import mma_mask, splice

    ids, valid = torch.as_tensor(rows["input_ids"]), torch.as_tensor(rows["attn_valid"])
    n_vis = model["perceiver"]["num_latents"]
    vis = torch.zeros(rows["slots"], n_vis, 1)
    out = []
    for r in range(ids.shape[0]):
        _, ok, _, blocks = splice(model, torch.zeros(ids.shape[1], 1), ids[r], valid[r], vis)
        out.append(mma_mask(ok.shape[0], ok, blocks, "cpu"))
    return torch.stack(out)


def valid_pairs(mask: torch.Tensor) -> int:
    """Allowed (query, key) pairs of ``mask`` whose query is a valid
    position too (a valid query may attend itself): the pairs the loss
    needs."""
    q_valid = torch.stack([mask[b].diagonal() for b in range(mask.shape[0])])
    return int((mask & q_valid[:, :, None]).sum())

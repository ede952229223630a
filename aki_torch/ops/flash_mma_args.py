"""The argument contract of the flash MMA CUDA kernels, shared by the
forward (:mod:`aki_torch.ops.flash_mma`) and the backward
(:mod:`aki_torch.ops.flash_mma_bwd`): input checks and the marshalling of
the mask arguments into the int32 tensors the kernels read."""

from __future__ import annotations

import torch

LOG2E = 1.4426950408889634
MAX_IMAGES = 16                 # kMaxImages of the kernels
SKIP, FULL, PARTIAL = 0, 1, 2   # tile classes of the forward kernel
TILE_CLASS_NAMES = ("skip", "full", "partial")
HEAD_DIMS = (72, 80, 88, 96)    # padded to the kernels' two widths, 80 and 96
FLAT_HEAD_DIMS = (128,)         # the forward's flat padded-head instance only
ONE_TILE = 1024                 # the single-tile TPU kernels' longest sequence (K6, K7)


def int32_rows(x, shape, device) -> torch.Tensor:
    """A scalar or a broadcastable int tensor as contiguous int32 ``shape``."""
    if isinstance(x, int):
        return torch.full(shape, x, dtype=torch.int32, device=device)
    return torch.as_tensor(x, device=device).to(torch.int32).expand(shape).contiguous()


def kernel_mask_args(spec, kv_valid, q_offset, b, s, device):
    """The kernels' mask arguments: (kv_valid int32 or None, q_offset int32,
    (img_start, txt_start, txt_end) int32 (B, n_img) or Nones, n_img)."""
    valid = None if kv_valid is None else int32_rows(kv_valid, (b, s), device)
    offset = int32_rows(q_offset, (b,), device)
    if spec is None:
        return valid, offset, (None, None, None), 0
    spec = spec.with_batch_dim()
    n_img = spec.img_start.shape[1]
    if n_img > MAX_IMAGES:
        raise ValueError(f"flash_mma: at most {MAX_IMAGES} images, got {n_img}")
    coords = tuple(int32_rows(c, (b, n_img), device)
                   for c in (spec.img_start, spec.txt_start, spec.txt_end))
    return valid, offset, coords, n_img


def check_kernel_inputs(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *more: tuple[str, torch.Tensor], head_dims=HEAD_DIMS) -> None:
    """Raise on anything the kernels do not take: q (B,T,H,D), k and v
    (B,S,Hkv,D), all bf16, contiguous and 16-byte aligned on one CUDA
    device, D in ``head_dims``; ``more`` are further (name, tensor) of q's
    shape."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q (B,T,H,D) and k, v (B,S,Hkv,D) expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or h % hkv:
        raise ValueError(f"{name}: k/v shape {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if d not in head_dims:
        raise ValueError(f"{name}: the kernel takes head dims {head_dims}, got {d}")
    if b == 0 or t == 0 or s == 0:
        raise ValueError(f"{name}: empty batch, query or key sequence")
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    for n, x in (("q", q), ("k", k), ("v", v), *more):
        if x.device != q.device:
            raise ValueError(f"{name}: {n} on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bf16, {n} is {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: {n} must be contiguous and 16-byte aligned")
    for n, x in more:
        if x.shape != q.shape:
            raise ValueError(f"{name}: {n} shape {tuple(x.shape)}, q {tuple(q.shape)}")


def tile_classes(spec, kv_valid, q_offset, t: int, s: int, causal: bool,
                 block_m: int = 64, block_n: int = 64) -> torch.Tensor:
    """The forward kernel's class of every (batch row, query tile of
    ``block_m`` rows, KV tile of ``block_n`` keys), as int8 ``SKIP``,
    ``FULL`` or ``PARTIAL`` of shape (B, ceil(T/block_m), ceil(S/block_n)).

    *skip*: no row of the tile reaches the tile's keys through the causal
    frontier or an MMA rectangle (``csrc/flash_mma_fwd.cu``'s visit test);
    never in non-causal mode. *full*: not skip, every key below the causal
    frontier of the tile's first row (or non-causal), and every key < S and
    valid. *partial*: the rest, the only tiles whose scores are masked.
    The consumer warpgroups classify at (64, 64); a block loads a KV tile
    unless it is skip at (block rows, 64). B comes from ``spec``,
    ``kv_valid`` or ``q_offset``, else 1. For tests and ``chip_smoke.py``:
    no path calls it."""
    sizes = [x.shape[0] for x in (spec.img_start if spec is not None else None,
                                  kv_valid, q_offset)
             if isinstance(x, torch.Tensor) and x.dim() > 0]
    b = max(sizes, default=1)
    nq, nk = -(-t // block_m), -(-s // block_n)
    off = torch.as_tensor(q_offset).to(torch.int64).cpu().expand(b)[:, None]
    q0 = torch.arange(nq)[None] * block_m
    first = off + q0                                            # (B, nq)
    last = off + torch.clamp(q0 + block_m, max=t) - 1
    k0 = torch.arange(nk) * block_n                             # (nk,)
    first, last = first[:, :, None], last[:, :, None]
    visit = torch.ones(b, nq, nk, dtype=torch.bool)
    below = torch.ones(b, nq, nk, dtype=torch.bool)
    if causal:
        visit = k0 <= last
        if spec is not None:
            spec = spec.with_batch_dim()
            i0, t0, t1 = (x.to(torch.int64).cpu().expand(b, -1)[:, None, None, :]
                          for x in (spec.img_start, spec.txt_start, spec.txt_end))
            kk = k0[None, None, :, None]
            rect = ((first[..., None] < t0) & (last[..., None] >= i0)
                    & (kk < t1) & (kk + block_n > t0))
            visit = visit | rect.any(-1)
        below = k0 + block_n - 1 <= first
    keys = torch.zeros(b, nk * block_n, dtype=torch.bool)
    keys[:, :s] = (torch.ones(b, s, dtype=torch.bool) if kv_valid is None
                   else torch.as_tensor(kv_valid).cpu().expand(b, s) != 0)
    keys_ok = keys.view(b, nk, block_n).all(-1)[:, None, :]
    full = visit & below & keys_ok
    out = torch.full((b, nq, nk), PARTIAL, dtype=torch.int8)
    out[full] = FULL
    out[~visit] = SKIP
    return out

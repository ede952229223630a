"""Flash attention backward with the modality-mutual (MMA) mask
(counterpart of ``aki_tpu/ops/flash_mma_bwd.py``).

On CUDA tensors :func:`run_backward` launches the two CUDA C++ kernels of
``csrc/flash_mma_bwd.cu`` (which replace the TPU kernels ``_dq_kernel`` and
``_dkv_kernel``; the header says what bounds them on an H100). The TPU's
third kernel, ``_lse_kernel``, has no counterpart of its own: the forward
kernel writes the row logsumexp (``csrc/flash_mma_fwd.cu``) and
:func:`flash_mma_lse_reference` is its plain version.

The row logsumexp is in base 2 of the scaled scores, ``lse = log2 sum_k
exp2(scale * log2(e) * q.k)`` over the allowed keys, +inf for a row with no
allowed key, so that ``p = exp2(scale * log2(e) * q.k - lse)`` — the base
the kernels use. :func:`flash_mma_backward_reference` spells out the
formulas of the kernels, with their bf16 rounding points, for the tests and
the CPU route only.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .attention import attention_mask
from .flash_mma_args import LOG2E, check_kernel_inputs, kernel_mask_args
from .masks import MMASpec

_lib = None


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 for bf16/f32 inputs (bf16 products are exact in f32), f64 for f64."""
    return torch.promote_types(x.dtype, torch.float32)


def _grouped(x: torch.Tensor, h: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, H, D): each KV head repeated over its group."""
    hkv = x.shape[2]
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} KV heads")
    return x if hkv == h else x.repeat_interleave(h // hkv, dim=2)


def _scores(q, k, spec, kv_valid, q_offset, causal, scale):
    """(x, ok): base-2 scaled scores (B, H, T, S) in the accumulation dtype
    and the (B, 1, T, S) mask."""
    b, t, h, _ = q.shape
    acc = _acc_dtype(q)
    x = torch.einsum("bthd,bshd->bhts", q.to(acc), _grouped(k, h).to(acc))
    x = x * (scale * LOG2E)
    ok = attention_mask(b, t, k.shape[1], q.device, spec if causal else None,
                        kv_valid, q_offset, causal)
    return x, ok


def flash_mma_lse_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    spec: MMASpec | None = None,
    kv_valid: torch.Tensor | None = None,
    q_offset: torch.Tensor | int = 0,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain version of the forward kernel's ``lse`` output (the function of
    the TPU's ``_lse_kernel``): (B, H, T) in base 2, +inf for empty rows; f32
    (f64 for f64 inputs)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    x, ok = _scores(q, k, spec, kv_valid, q_offset, causal, scale)
    x = x.masked_fill(~ok, -torch.inf)
    m = x.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    l = torch.exp2(x - m_safe).sum(dim=-1)
    return torch.where(l > 0, m_safe[..., 0] + torch.log2(l), torch.inf)


def flash_mma_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    spec: MMASpec | None = None,
    kv_valid: torch.Tensor | None = None,
    q_offset: torch.Tensor | int = 0,
    causal: bool = True,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`run_backward`: (dq, dk, dv) in the dtypes of
    q, k, v. Every product accumulates in f32 (f64 for f64 inputs); p is
    rounded to dO's dtype and ds to q's before their products, as in the
    kernels; GQA dk/dv are summed over the group before the final cast."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    acc = _acc_dtype(q)
    x, ok = _scores(q, k, spec, kv_valid, q_offset, causal, scale)
    p = torch.where(ok, torch.exp2(x - lse.to(acc)[..., None]), 0.0)
    delta = (do.to(acc) * o.to(acc)).sum(-1).transpose(1, 2)          # (B, H, T)
    dp = torch.einsum("bthd,bshd->bhts", do.to(acc), _grouped(v, h).to(acc))
    ds = p * (dp - delta[..., None]) * scale
    dv = torch.einsum("bhts,bthd->bshd", p.to(do.dtype).to(acc), do.to(acc))
    ds_r = ds.to(q.dtype).to(acc)
    dq = torch.einsum("bhts,bshd->bthd", ds_r, _grouped(k, h).to(acc))
    dk = torch.einsum("bhts,bthd->bshd", ds_r, q.to(acc))
    dk = dk.reshape(b, s, hkv, h // hkv, d).sum(3)
    dv = dv.reshape(b, s, hkv, h // hkv, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("flash_mma_bwd")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_mma_bwd_dq.argtypes = [p] * 12 + [i] * 8 + [f, f, p]
        lib.flash_mma_bwd_dkv.argtypes = [p] * 13 + [i] * 8 + [f, f, p]
        lib.flash_mma_bwd_dq.restype = lib.flash_mma_bwd_dkv.restype = i
        lib.flash_mma_bwd_error_string.argtypes = [i]
        lib.flash_mma_bwd_error_string.restype = ctypes.c_char_p
        lib.flash_mma_bwd_count_tiles.argtypes = [p, p]
        lib.flash_mma_bwd_count_tiles.restype = None
        lib.flash_mma_bwd_block_rows.argtypes = [i] * 6
        lib.flash_mma_bwd_block_rows.restype = i
        _lib = lib
    return _lib


def _ptr(x):
    return None if x is None else x.data_ptr()


def run_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    spec: MMASpec | None = None,
    kv_valid: torch.Tensor | None = None,
    q_offset: torch.Tensor | int = 0,
    causal: bool = True,
    scale: float | None = None,
    mask_args: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of flash MMA attention on CUDA tensors: ``dq`` and
    ``dkv`` kernel launches, counted in ``run_backward.dq_launches`` and
    ``run_backward.dkv_launches``. q, o, do (B,T,H,D) and k, v (B,S,Hkv,D)
    bf16 contiguous; lse (B,H,T) f32 from the forward kernel. Raises on
    anything the kernels do not take (a non-contiguous ``do`` is the
    caller's to make contiguous). delta = rowsum(do * o) is computed here in
    f32, outside the kernels, as the JAX package does. ``mask_args``: the
    forward's ``kernel_mask_args`` of the same mask, when the caller kept
    them (``FlashMMAFunction``); built here otherwise."""
    check_kernel_inputs("flash_mma_bwd", q, k, v, ("o", o), ("do", do))
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    if lse.shape != (b, h, t) or lse.dtype != torch.float32 or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError(f"flash_mma_bwd: lse must be contiguous f32 {(b, h, t)} on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
    dev = q.device
    if mask_args is None:
        mask_args = kernel_mask_args(spec if causal else None, kv_valid, q_offset, b, s, dev)
    valid, offset, coords, n_img = mask_args
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()   # (B, H, T)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _kernel_lib()
    mask = (_ptr(valid), _ptr(offset), *(_ptr(c) for c in coords))
    dims = (n_img, b, t, s, h, hkv, d, int(causal), float(scale) * LOG2E, float(scale))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_mma_bwd_dq(_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse),
                                  _ptr(delta), _ptr(dq), *mask, *dims, stream)
        if rc == 0:
            run_backward.dq_launches += 1
            rc = lib.flash_mma_bwd_dkv(_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse),
                                       _ptr(delta), _ptr(dk), _ptr(dv), *mask, *dims,
                                       stream)
            if rc == 0:
                run_backward.dkv_launches += 1
    if rc != 0:
        raise RuntimeError("flash_mma_bwd launch failed: "
                           + lib.flash_mma_bwd_error_string(rc).decode())
    return dq, dk, dv


run_backward.dq_launches = 0
run_backward.dkv_launches = 0


def count_backward_tiles(dq_counts: torch.Tensor | None,
                         dkv_counts: torch.Tensor | None) -> None:
    """Point the kernels' tile counters at two int32 (3,) tensors on the
    card (Nones stop them); see ``flash_mma.count_tiles``."""
    _kernel_lib().flash_mma_bwd_count_tiles(_ptr(dq_counts), _ptr(dkv_counts))


def backward_block_rows(b: int, t: int, s: int, h: int, hkv: int) -> tuple[int, int]:
    """(query rows per ``dq`` block, keys per ``dkv`` block) that the
    kernels take for ``b`` x ``t`` query rows of ``h`` heads over ``s``
    keys of ``hkv`` heads on the current CUDA device."""
    lib = _kernel_lib()
    return (lib.flash_mma_bwd_block_rows(b, t, s, h, hkv, 0),
            lib.flash_mma_bwd_block_rows(b, t, s, h, hkv, 1))

"""Flash attention forward with the modality-mutual (MMA) mask
(counterpart of ``aki_tpu/ops/flash_mma.py:flash_mma_attention``).

On a CUDA tensor :func:`flash_mma_attention` always launches the CUDA C++
kernel of ``csrc/flash_mma_fwd.cu`` (which replaces the TPU kernels
``_kernel_1kv`` and ``_kernel``; its header says what bounds it on an H100
and what the design does about that). On a CPU tensor it takes the plain
version, :func:`flash_mma_attention_reference`. A single query row
(decode) goes to :func:`dense_attention`, as in the JAX package.

The mask contract is the one of :mod:`aki_torch.ops.masks`; in non-causal
mode (the vision tower) only ``kv_valid`` masks keys.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .attention import dense_attention
from .masks import MMASpec

_LOG2E = 1.4426950408889634
MAX_IMAGES = 16          # kMaxImages of the kernel
HEAD_DIMS = (72, 80, 88, 96)   # padded to the kernel's two widths, 80 and 96
_lib = None


def flash_mma_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    spec: MMASpec | None = None,
    kv_valid: torch.Tensor | None = None,
    q_offset: torch.Tensor | int = 0,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: :func:`dense_attention`'s math
    under the kernel's argument semantics (non-causal ignores ``spec``)."""
    return dense_attention(
        q, k, v, spec=spec if causal else None, kv_valid=kv_valid,
        q_offset=q_offset, causal=causal, scale=scale,
    )


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("flash_mma_fwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_mma_fwd.argtypes = [p] * 9 + [i] * 8 + [ctypes.c_float, p]
        lib.flash_mma_fwd.restype = i
        lib.flash_mma_error_string.argtypes = [i]
        lib.flash_mma_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _int32_rows(x, shape, device) -> torch.Tensor:
    if isinstance(x, int):
        return torch.full(shape, x, dtype=torch.int32, device=device)
    return torch.as_tensor(x, device=device).to(torch.int32).expand(shape).contiguous()


def _launch(q, k, v, spec, kv_valid, q_offset, causal, scale) -> torch.Tensor:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_mma: q (B,T,H,D) and k, v (B,S,Hkv,D) expected, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    dev = q.device
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or h % hkv:
        raise ValueError(f"flash_mma: k/v shape {tuple(k.shape)} does not fit "
                         f"q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_mma: the kernel takes head dims {HEAD_DIMS}, got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != dev:
            raise ValueError(f"flash_mma: {name} on {x.device}, q on {dev}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_mma: the kernel takes bf16, {name} is {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_mma: {name} must be contiguous and 16-byte aligned")
    if b == 0 or t == 0 or s == 0:
        raise ValueError("flash_mma: empty batch, query or key sequence")

    valid = None if kv_valid is None else _int32_rows(kv_valid, (b, s), dev)
    offset = _int32_rows(q_offset, (b,), dev)
    if spec is None:
        n_img, coords = 0, (None, None, None)
    else:
        spec = spec.with_batch_dim()
        n_img = spec.img_start.shape[1]
        if n_img > MAX_IMAGES:
            raise ValueError(f"flash_mma: at most {MAX_IMAGES} images, got {n_img}")
        coords = tuple(_int32_rows(c, (b, n_img), dev)
                       for c in (spec.img_start, spec.txt_start, spec.txt_end))

    out = torch.empty_like(q)
    lib = _kernel_lib()
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        rc = lib.flash_mma_fwd(
            ptr(q), ptr(k), ptr(v), ptr(out), ptr(valid), ptr(offset),
            *(ptr(c) for c in coords), n_img, b, t, s, h, hkv, d, int(causal),
            float(scale) * _LOG2E, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError("flash_mma_fwd launch failed: "
                           + lib.flash_mma_error_string(rc).decode())
    flash_mma_attention.launches += 1
    return out


def flash_mma_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    spec: MMASpec | None = None,
    kv_valid: torch.Tensor | None = None,
    q_offset: torch.Tensor | int = 0,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Flash MMA attention. q (B, T, H, D); k, v (B, S, Hkv, D) with
    Hkv | H; ``spec``/``kv_valid``/``q_offset`` as in
    :func:`~aki_torch.ops.attention.dense_attention`. Returns (B, T, H, D).

    CUDA tensors (bf16, contiguous, D in ``HEAD_DIMS``) launch the
    kernel, and nothing else; CPU tensors take the plain version.
    ``flash_mma_attention.launches`` counts kernel launches.
    """
    if q.shape[1] == 1:
        return dense_attention(q, k, v, spec=spec, kv_valid=kv_valid,
                               q_offset=q_offset, causal=causal, scale=scale)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_mma_attention_reference(
            q, k, v, spec=spec, kv_valid=kv_valid, q_offset=q_offset,
            causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mma: no kernel for device {q.device}")
    return _launch(q, k, v, spec, kv_valid, q_offset, causal, scale)


flash_mma_attention.launches = 0

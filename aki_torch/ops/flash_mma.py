"""Flash attention with the modality-mutual (MMA) mask, forward and
backward (counterpart of ``aki_tpu/ops/flash_mma.py:flash_mma_attention``
and its ``custom_vjp``).

:func:`flash_mma_attention` runs as a ``torch.autograd.Function``. On CUDA
tensors it always launches the CUDA C++ kernel of ``csrc/flash_mma_fwd.cu``
(which replaces the TPU kernels ``_kernel_1kv`` and ``_kernel``; its header
says what bounds it on an H100 and what the design does about that); when
an input needs a gradient the kernel also writes the row logsumexp, and the
backward launches the ``dq`` and ``dkv`` kernels of ``csrc/flash_mma_bwd.cu``
through :func:`~aki_torch.ops.flash_mma_bwd.run_backward`. On CPU tensors
the same function runs the plain forward,
:func:`flash_mma_attention_reference`, and the plain backward,
:func:`~aki_torch.ops.flash_mma_bwd.flash_mma_backward_reference`. A single
query row (decode) goes to :func:`dense_attention`, as in the JAX package.

The mask contract is the one of :mod:`aki_torch.ops.masks`; in non-causal
mode (the vision tower) only ``kv_valid`` masks keys. The kernels' argument
contract is :mod:`aki_torch.ops.flash_mma_args`.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .attention import dense_attention
from .flash_mma_args import LOG2E, check_kernel_inputs, kernel_mask_args
from .flash_mma_bwd import flash_mma_backward_reference, flash_mma_lse_reference, run_backward
from .masks import MMASpec

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
        lib.flash_mma_fwd.argtypes = [p] * 10 + [i] * 8 + [ctypes.c_float, p]
        lib.flash_mma_fwd.restype = i
        lib.flash_mma_error_string.argtypes = [i]
        lib.flash_mma_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def flash_mma_forward(q, k, v, spec=None, kv_valid=None, q_offset=0, causal=True,
                      scale=None, with_lse=False):
    """The forward kernel on CUDA tensors (counted in
    ``flash_mma_attention.launches``): (out, lse), lse the base-2 row
    logsumexp (B, H, T) f32 when ``with_lse``, else None. Not
    differentiable: use :func:`flash_mma_attention`."""
    check_kernel_inputs("flash_mma", q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, t, h, _ = q.shape
    s, hkv = k.shape[1], k.shape[2]
    dev = q.device
    valid, offset, coords, n_img = kernel_mask_args(spec, kv_valid, q_offset, b, s, dev)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=dev) if with_lse else None
    lib = _kernel_lib()
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        rc = lib.flash_mma_fwd(
            ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse), ptr(valid), ptr(offset),
            *(ptr(c) for c in coords), n_img, b, t, s, h, hkv, q.shape[3], int(causal),
            float(scale) * LOG2E, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError("flash_mma_fwd launch failed: "
                           + lib.flash_mma_error_string(rc).decode())
    flash_mma_attention.launches += 1
    return out, lse


class FlashMMAFunction(torch.autograd.Function):
    """Counterpart of ``_flash`` / ``_flash_fwd`` / ``_flash_bwd``
    (``aki_tpu/ops/flash_mma.py:598-789``, ``BACKWARD_IMPL = "flash"``):
    the kernels on CUDA tensors, the plain versions on CPU tensors. The row
    logsumexp is computed and q, k, v, out kept only when q, k or v needs a
    gradient. The mask arguments (spec, kv_valid, q_offset) are small
    integer tensors kept on the context; they get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, spec, kv_valid, q_offset, causal, scale):
        with_lse = any(ctx.needs_input_grad[:3])
        if q.device.type == "cpu":
            out = flash_mma_attention_reference(q, k, v, spec, kv_valid, q_offset,
                                                causal, scale)
            lse = (flash_mma_lse_reference(q, k, spec, kv_valid, q_offset, causal, scale)
                   if with_lse else None)
        else:
            out, lse = flash_mma_forward(q, k, v, spec, kv_valid, q_offset, causal,
                                         scale, with_lse=with_lse)
        if with_lse:
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.mask = (spec, kv_valid, q_offset, causal, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = flash_mma_backward_reference(q, k, v, out, do, lse, *ctx.mask)
        else:
            grads = run_backward(q, k, v, out, do.contiguous(), lse, *ctx.mask)
        return (*grads, None, None, None, None, None)


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

    CUDA tensors (bf16, contiguous, D in ``flash_mma_args.HEAD_DIMS``) launch the
    kernels, and nothing else; CPU tensors take the plain versions. It is
    differentiable in q, k and v. ``flash_mma_attention.launches`` counts
    forward kernel launches; ``run_backward.dq_launches`` and
    ``.dkv_launches`` count the backward's.
    """
    if q.shape[1] == 1:
        return dense_attention(q, k, v, spec=spec, kv_valid=kv_valid,
                               q_offset=q_offset, causal=causal, scale=scale)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_mma: no kernel for device {q.device}")
    return FlashMMAFunction.apply(q, k, v, spec, kv_valid, q_offset, causal, scale)


flash_mma_attention.launches = 0

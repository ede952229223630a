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

:func:`flash_mma_attention_flat` is the same forward over the flat
padded-head layout ``(B, T, H*128)`` (counterpart of
``flash_mma_attention_flat``, whose TPU kernel is ``_kernel_1kv_flat``): on
CUDA tensors it launches the forward kernel's width-128 instance and counts
``flash_mma_attention_flat.launches``; on CPU tensors it runs
:func:`flash_mma_attention_flat_reference`. Inference only, as in JAX.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from . import cuda_build
from .attention import dense_attention
from .flash_mma_args import (FLAT_HEAD_DIMS, LOG2E, ONE_TILE, check_kernel_inputs,
                             kernel_mask_args)
from .flash_mma_bwd import (count_backward_tiles, flash_mma_backward_reference,
                            flash_mma_lse_reference, run_backward)
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
        lib.flash_mma_fwd_flat.argtypes = [p] * 9 + [i] * 7 + [ctypes.c_float, p]
        lib.flash_mma_fwd_flat.restype = i
        lib.flash_mma_error_string.argtypes = [i]
        lib.flash_mma_error_string.restype = ctypes.c_char_p
        lib.flash_mma_count_tiles.argtypes = [p]
        lib.flash_mma_count_tiles.restype = None
        lib.flash_mma_fwd_block_rows.argtypes = [i] * 4
        lib.flash_mma_fwd_block_rows.restype = i
        _lib = lib
    return _lib


def flash_mma_forward(q, k, v, spec=None, kv_valid=None, q_offset=0, causal=True,
                      scale=None, with_lse=False, mask_args=None):
    """The forward kernel on CUDA tensors (counted in
    ``flash_mma_attention.launches``): (out, lse), lse the base-2 row
    logsumexp (B, H, T) f32 when ``with_lse``, else None. ``mask_args``:
    ``kernel_mask_args`` of the mask, built here when None. Not
    differentiable: use :func:`flash_mma_attention`."""
    check_kernel_inputs("flash_mma", q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, t, h, _ = q.shape
    s, hkv = k.shape[1], k.shape[2]
    dev = q.device
    if mask_args is None:
        mask_args = kernel_mask_args(spec, kv_valid, q_offset, b, s, dev)
    valid, offset, coords, n_img = mask_args
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
    integer tensors kept on the context; they get no gradient. On CUDA the
    int32 tensors the kernels read are built once, for the forward kernel,
    and kept for the backward's."""

    @staticmethod
    def forward(ctx, q, k, v, spec, kv_valid, q_offset, causal, scale):
        with_lse = any(ctx.needs_input_grad[:3])
        mask_args = None
        if q.device.type == "cpu":
            out = flash_mma_attention_reference(q, k, v, spec, kv_valid, q_offset,
                                                causal, scale)
            lse = (flash_mma_lse_reference(q, k, spec, kv_valid, q_offset, causal, scale)
                   if with_lse else None)
        else:
            mask_args = kernel_mask_args(spec, kv_valid, q_offset, q.shape[0], k.shape[1],
                                         q.device)
            out, lse = flash_mma_forward(q, k, v, spec, kv_valid, q_offset, causal,
                                         scale, with_lse=with_lse, mask_args=mask_args)
        if with_lse:
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.mask = (spec, kv_valid, q_offset, causal, scale)
            ctx.mask_args = mask_args
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = flash_mma_backward_reference(q, k, v, out, do, lse, *ctx.mask)
        else:
            grads = run_backward(q, k, v, out, do.contiguous(), lse, *ctx.mask,
                                 mask_args=ctx.mask_args)
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


TILE_COUNTERS = ("fwd", "dq", "dkv")   # the rows of count_tiles()'s tensor


@contextlib.contextmanager
def count_tiles(device="cuda"):
    """For checks: while open, every launch of the flash kernels adds the
    tiles its consumer warpgroups ran, by class, to the int32 (3, 3) tensor
    yielded: row ``TILE_COUNTERS.index(kernel)``, columns ``[skip, full,
    partial]``, in the units of ``flash_mma_args.tile_classes`` (64 query
    rows x 64 keys). The forward (K1, K2, K6) and ``dq`` count per query
    tile and KV tile, summed over heads, batch rows and query tiles; ``dkv``
    per KV tile and query tile of each head of its GQA group, so that every
    kernel sums to the heads times the mirror's classes. It costs one
    atomic per tile; read the tensor after the launches (it is on
    ``device``)."""
    counts = torch.zeros(len(TILE_COUNTERS), 3, dtype=torch.int32, device=device)
    lib = _kernel_lib()
    lib.flash_mma_count_tiles(counts[0].data_ptr())
    count_backward_tiles(counts[1], counts[2])
    try:
        yield counts
    finally:
        lib.flash_mma_count_tiles(None)
        count_backward_tiles(None, None)


def forward_block_rows(b: int, t: int, h: int, d: int) -> int:
    """The query rows per block that the forward kernel takes for ``b`` x
    ``t`` query rows of ``h`` heads at head dim ``d`` (128: the flat entry)
    on the current CUDA device."""
    return _kernel_lib().flash_mma_fwd_block_rows(b, t, h, d)


def _flat_heads(q, k, v, num_heads: int) -> int:
    """The padded head width DP of the flat layout; raises as JAX does."""
    b, t, f = q.shape
    dp = f // num_heads
    if dp * num_heads != f or dp % 128:
        raise ValueError(f"flat layout needs 128-multiple padded heads; "
                         f"got last dim {f} for {num_heads} heads")
    if k.dim() != 3 or k.shape != v.shape or k.shape[0] != b or k.shape[2] != f:
        raise ValueError(f"flat layout: k, v (B,S,{f}) expected, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if -(-k.shape[1] // 128) * 128 > ONE_TILE or t > ONE_TILE:
        raise ValueError("flat path is single-KV-tile; sequence too long")
    return dp


def flash_mma_attention_flat_reference(q, k, v, num_heads, head_dim, spec=None,
                                       kv_valid=None, q_offset=0, causal=True, scale=None):
    """Plain version of :func:`flash_mma_attention_flat`: the plain forward
    over the ``(B, T, H, DP)`` view, with the real head dim's scale."""
    b, t, f = q.shape
    dp = f // num_heads
    view = lambda x: x.reshape(b, x.shape[1], num_heads, dp)  # noqa: E731
    out = flash_mma_attention_reference(
        view(q), view(k), view(v), spec=spec, kv_valid=kv_valid, q_offset=q_offset,
        causal=causal, scale=head_dim ** -0.5 if scale is None else scale)
    return out.reshape(b, t, f)


def flash_mma_attention_flat(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    head_dim: int,
    spec: MMASpec | None = None,
    kv_valid: torch.Tensor | None = None,
    q_offset: torch.Tensor | int = 0,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Flash MMA attention over the flat padded-head layout.

    q, k, v (B, T|S, H*DP), DP a multiple of 128, the real head dims in the
    low lanes of each DP block and zeros in the pad lanes; ``head_dim`` is
    the REAL head dim (the scale is ``head_dim**-0.5``). T and S rounded up
    to 128 at most 1024, else ``ValueError``. Other arguments as
    :func:`flash_mma_attention`. Returns (B, T, H*DP) in q's dtype; P.V is
    written over the pad lanes too (zero where V's pad lanes are zero).

    CUDA tensors (bf16, DP 128) launch the kernel, a single query row
    included, and nothing else; CPU tensors take the plain version. Not
    differentiable: inference only.
    """
    dp = _flat_heads(q, k, v, num_heads)
    if scale is None:
        scale = head_dim ** -0.5
    if q.device.type == "cpu":
        return flash_mma_attention_flat_reference(q, k, v, num_heads, head_dim, spec,
                                                  kv_valid, q_offset, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mma_flat: no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError("flash_mma_flat: inference only, the kernel has no backward")
    b, t, _ = q.shape
    s = k.shape[1]
    check_kernel_inputs("flash_mma_flat", q.view(b, t, num_heads, dp),
                        k.view(b, s, num_heads, dp), v.view(b, s, num_heads, dp),
                        head_dims=FLAT_HEAD_DIMS)
    valid, offset, coords, n_img = kernel_mask_args(spec, kv_valid, q_offset, b, s, q.device)
    out = torch.empty_like(q)
    lib = _kernel_lib()
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(q.device):
        rc = lib.flash_mma_fwd_flat(
            ptr(q), ptr(k), ptr(v), ptr(out), ptr(valid), ptr(offset),
            *(ptr(c) for c in coords), n_img, b, t, s, num_heads, num_heads, int(causal),
            float(scale) * LOG2E, torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError("flash_mma_fwd_flat launch failed: "
                           + lib.flash_mma_error_string(rc).decode())
    flash_mma_attention_flat.launches += 1
    return out


flash_mma_attention_flat.launches = 0


class _GatherSeq(torch.autograd.Function):
    """All-gather along T (dim 1) over the ``seq`` group; its transpose,
    the backward, reduce-scatters the gradient (a sum over the ranks that
    used each key)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        n = dist.get_world_size(group)
        ctx.group, ctx.n = group, n
        xt = x.transpose(0, 1).contiguous()
        out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
        dist.all_gather_into_tensor(out, xt, group=group)
        return out.transpose(0, 1).contiguous()      # the kernels read contiguous K/V

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        gt = g.transpose(0, 1).contiguous()
        out = gt.new_empty((gt.shape[0] // ctx.n,) + tuple(gt.shape[1:]))
        dist.reduce_scatter_tensor(out, gt, group=ctx.group)
        return out.transpose(0, 1), None


def flash_mma_attention_sp(q, k, v, shard, scale: float | None = None) -> torch.Tensor:
    """Sequence-parallel flash MMA attention (counterpart of
    ``flash_mma_attention_sp``, ``aki_tpu/ops/flash_mma.py:804-868``): q, k,
    v (B, T/n, H, D) are this rank's rows (``shard``: a
    :class:`~aki_torch.ops.ring_attention.SeqShard`); K/V are all-gathered
    along T and :func:`flash_mma_attention` runs on the local query rows at
    ``q_offset = rank * T/n`` over all T keys (on CUDA tensors the forward
    and backward kernels). The gather's backward reduce-scatters dK/dV."""
    k_full = _GatherSeq.apply(k, shard.group)
    v_full = _GatherSeq.apply(v, shard.group)
    shard.seen_kv_rows.append(k_full.shape[1])
    return flash_mma_attention(q, k_full, v_full, spec=shard.spec, kv_valid=shard.kv_valid,
                               q_offset=shard.lo, scale=scale)


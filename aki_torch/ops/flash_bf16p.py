"""Flash attention with bf16 probabilities: the attention of the quantized
serving prefill (decoder and vision tower) on the card.

The JAX package runs this attention as plain XLA
(``aki_tpu/ops/attention.py:decoder_attention_xla``, ``encoder_attention_xla``)
and so does the port on CPU tensors
(:func:`~aki_torch.ops.attention.decoder_attention_bf16p`,
:func:`~aki_torch.ops.attention.encoder_attention_bf16p`). On bf16 CUDA
tensors those two call :func:`flash_bf16p_attention`, which launches the
CUDA C++ kernel of ``csrc/flash_bf16p.cu`` (its header says what it
computes, what bounds it and why it makes two passes over K), counted in
``flash_bf16p_attention.launches``. The kernel keeps the route's numerics:
f32 scores, the row's final max, ``p`` rounded to bf16, ``l`` the f32 sum of
the rounded ``p``, the PV product divided by ``l`` after it; it works in
base 2 with ``log2(e)`` folded into the scale, and its exp2 flushes a ``p``
below 2^-126 to zero. Inference only.

:func:`flash_bf16p_reference` is the kernel's arithmetic in its order (two
passes over 64-key tiles), what the CPU tests hold to JAX and the wrapper
runs on CPU tensors; :func:`bf16p_plan` mirrors the kernel's launch plan and
:func:`bf16p_blocks` the order of its blocks.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .attention import attention_mask
from .flash_mma_args import LOG2E, MAX_IMAGES, check_kernel_inputs, kernel_mask_args
from .masks import MMASpec

_lib = None

# The kernel's launch constants (csrc/flash_bf16p.cu, csrc/hopper.cuh)
TILE_BYTES = 64 * 128        # one chunk of a 64-row tile (kTileBytes)
BLOCK_N = 64                 # keys per KV tile (kBlockN)
MAX_SMEM = 232448            # dynamic shared bytes a block may use
SM_SMEM = 233472             # shared bytes of an SM, 1 KB of them reserved per block


def flash_bf16p_reference(q, k, v, spec=None, kv_valid=None, q_offset=0, causal=True,
                          scale=None) -> torch.Tensor:
    """Plain version of the kernel, step by step in its order: pass 1 the
    row max ``m`` of ``s = (q.k in f32) * f32(scale * log2(e))`` over every
    allowed key, tile by tile; pass 2 ``p = bf16(exp2(s - m))``, ``l`` the
    f32 sum of the rounded ``p`` and ``acc`` the f32 sum of ``p * v``, tile
    by tile; ``acc / l``, or 0 for a row with no allowed key. Masks as
    :func:`~aki_torch.ops.attention.dense_attention` (non-causal ignores
    ``spec``); GQA by repeating K/V. (B, T, H, D) in q's dtype."""
    b, t, h, d = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    if hkv != h:
        if h % hkv:
            raise ValueError(f"{h} query heads do not group over {hkv} KV heads")
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    ok = attention_mask(b, t, s_len, q.device, spec if causal else None, kv_valid, q_offset,
                        causal)
    dev = q.device
    scale_log2 = torch.tensor(float(scale) * LOG2E, dtype=torch.float32, device=dev)
    qf, kf, vf = q.float(), k.float(), v.float()
    tiles = [slice(j, j + BLOCK_N) for j in range(0, s_len, BLOCK_N)]

    def scores(j):
        # bf16 x bf16 products are exact in f32: the f32-accumulated dot
        s = torch.einsum("bthd,bshd->bhts", qf, kf[:, j]) * scale_log2
        return s.masked_fill(~ok[..., j], float("-inf"))

    m = torch.full((b, h, t, 1), float("-inf"), device=dev)
    for j in tiles:
        m = torch.maximum(m, scores(j).amax(dim=-1, keepdim=True))
    live = m > float("-inf")
    m_use = torch.where(live, m, 0.0)
    l = torch.zeros(b, h, t, 1, device=dev)
    acc = torch.zeros(b, h, t, d, device=dev)
    for j in tiles:
        p = torch.exp2(scores(j) - m_use).to(torch.bfloat16).float()
        l = l + p.sum(dim=-1, keepdim=True)
        acc = acc + torch.einsum("bhts,bshd->bhtd", p, vf[:, j])
    out = torch.where(live, acc / torch.where(live, l, 1.0), 0.0)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def bf16p_plan(b: int, t: int, h: int, sms: int) -> dict:
    """The launch plan of the kernel (``csrc/flash_bf16p.cu:flash_bf16p_plan``)
    for ``b`` x ``t`` query rows of ``h`` heads on ``sms`` SMs: ``rows`` per
    block (192, three consumer warpgroups, once B*H*ceil(T/192) fills two
    waves; else 64, two blocks to an SM), K/V ring ``stages`` (3, or 2 at
    64 rows), ``smem`` bytes (Q, the ring's K and V, the mbarriers, the
    key-validity masks, the image coordinates, 1024 of alignment)."""
    nc = 3 if b * h * -(-t // 192) >= 2 * sms else 1
    stages = 3 if nc == 3 else 2
    smem = (1024 + (2 * nc + 4 * stages) * TILE_BYTES + 8 * (1 + 3 * stages)
            + 3 * MAX_IMAGES * 4)
    return {"rows": 64 * nc, "stages": stages, "smem": smem}


def bf16p_blocks(plan: dict, b: int, t: int, h: int, causal: bool) -> list[tuple[int, int, int]]:
    """The kernel's blocks in launch order (blockIdx x fastest, then y, z):
    (first query row, head, batch row). The query tiles of one (head, batch
    row) are neighbours; causal puts the last (longest KV walk) first."""
    rows = plan["rows"]
    nq = -(-t // rows)
    return [((nq - 1 - x if causal else x) * rows, y, z)
            for z in range(b) for y in range(h) for x in range(nq)]


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("flash_bf16p")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_bf16p.argtypes = [p] * 9 + [i] * 8 + [ctypes.c_float, p]
        lib.flash_bf16p.restype = i
        lib.flash_bf16p_error_string.argtypes = [i]
        lib.flash_bf16p_error_string.restype = ctypes.c_char_p
        lib.flash_bf16p_plan.argtypes = [i] * 3 + [p]
        lib.flash_bf16p_plan.restype = i
        _lib = lib
    return _lib


def kernel_plan(b: int, t: int, h: int) -> dict:
    """The plan the kernel takes on the current CUDA device (C entry
    ``flash_bf16p_plan``), in :func:`bf16p_plan`'s keys."""
    out = (ctypes.c_int * 3)()
    lib = _kernel_lib()
    rc = lib.flash_bf16p_plan(b, t, h, out)
    if rc != 0:
        raise RuntimeError("flash_bf16p_plan failed: " + lib.flash_bf16p_error_string(rc).decode())
    return {"rows": out[0], "stages": out[1], "smem": out[2]}


def flash_bf16p_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    spec: MMASpec | None = None,
    kv_valid: torch.Tensor | None = None,
    q_offset: torch.Tensor | int = 0,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention with bf16 probabilities (inference only).

    q (B, T, H, D); k, v (B, S, Hkv, D) with Hkv | H; the mask arguments as
    :func:`~aki_torch.ops.flash_mma.flash_mma_attention` (non-causal: only
    ``kv_valid`` masks keys). Returns (B, T, H, D) in q's dtype.

    CUDA tensors (bf16, D in ``flash_mma_args.HEAD_DIMS``) launch the kernel
    and nothing else (on contiguous copies of q, k, v that are views, such
    as the tower's slices of its fused q|k|v product); CPU tensors take
    :func:`flash_bf16p_reference`.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_bf16p_reference(q, k, v, spec, kv_valid, q_offset, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bf16p: no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError("flash_bf16p: inference only, the kernel has no backward")
    q, k, v = (x.contiguous() for x in (q, k, v))
    check_kernel_inputs("flash_bf16p", q, k, v)
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    valid, offset, coords, n_img = kernel_mask_args(spec if causal else None, kv_valid,
                                                    q_offset, b, s, q.device)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lib = _kernel_lib()
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(q.device):
        rc = lib.flash_bf16p(
            ptr(q), ptr(k), ptr(v), ptr(out), ptr(valid), ptr(offset),
            *(ptr(c) for c in coords), n_img, b, t, s, h, hkv, d, int(causal),
            float(scale) * LOG2E, torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError("flash_bf16p launch failed: "
                           + lib.flash_bf16p_error_string(rc).decode())
    flash_bf16p_attention.launches += 1
    return out


flash_bf16p_attention.launches = 0

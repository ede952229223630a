"""Flash MMA forward over int8 q/k/v (counterpart of
``aki_tpu/ops/flash_mma.py:flash_mma_attention_q8``, whose TPU kernel is
``_kernel_1kv_q8``).

:func:`flash_mma_attention_q8` routes first, exactly as the JAX wrapper
does: with GQA (Hkv != H), or T or S rounded up to 128 past 1024, it is
:func:`~aki_torch.ops.flash_mma.flash_mma_attention` (the bf16 kernel,
counted there). Otherwise it quantizes q, k and v per (token, head) row over
the head dim (:func:`quantize_heads`, plain PyTorch as JAX leaves it to
XLA), folds ``scale * log2(e)`` into q's scales, and on CUDA tensors
launches the CUDA C++ kernel of ``csrc/flash_mma_q8.cu`` (its header says
what it computes, what bounds it and why it makes two passes over K),
counted in ``flash_mma_attention_q8.launches``; on CPU tensors it runs the
plain version, :func:`flash_mma_q8_plain`. Inference only, as in JAX.

:func:`q8_plan` mirrors the kernel's launch plan (query rows per block,
ring stages, shared bytes) and :func:`q8_blocks`
the order of its blocks; :func:`count_q8_tiles` reads the tiles each of
its two passes ran, by class, on the card.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from . import cuda_build
from .attention import attention_mask
from .flash_mma import flash_mma_attention, flash_mma_attention_reference
from .flash_mma_args import HEAD_DIMS, LOG2E, MAX_IMAGES, ONE_TILE, kernel_mask_args
from .fused_quant import quantize_rows
from .masks import MMASpec

_lib = None

# The kernel's launch constants (csrc/flash_mma_q8.cu, csrc/hopper.cuh)
TILE_BYTES = 64 * 128        # one int8 tile of 64 rows x 128 bytes (kTileBytes)
MAX_TILES = ONE_TILE // 64   # KV tiles of S <= 1024 (kMaxTiles)
MAX_SMEM = 232448            # dynamic shared bytes a block may use (kMaxSmem)
PASSES = 2                   # count_q8_tiles() rows: the max pass, the P.V pass


def quantize_heads(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, H, D) -> (int8 same shape, f32 (B, T, H) scales): symmetric
    per (token, head) row, s = amax/127 (1 for a zero row), round half to
    even, clip to +-127 (JAX ``_quantize_heads``)."""
    q, s = quantize_rows(x.float())
    return q, s[..., 0]


def routes_to_flash(q: torch.Tensor, k: torch.Tensor) -> bool:
    """True where the JAX wrapper calls ``flash_mma_attention`` instead of
    its kernel: GQA, or T or S rounded up to 128 past one 1024 tile."""
    pad = lambda n: max(128, -(-n // 128) * 128)  # noqa: E731
    return k.shape[2] != q.shape[2] or pad(q.shape[1]) > ONE_TILE or pad(k.shape[1]) > ONE_TILE


def quantize_operands(q, k, v, scale: float):
    """(q8, sq, k8, sk, v8, sv): the kernel's operands, scale*log2(e) folded
    into q's scales in f32."""
    q8, sq = quantize_heads(q)
    k8, sk = quantize_heads(k)
    v8, sv = quantize_heads(v)
    sq = sq * torch.tensor(scale * LOG2E, dtype=torch.float32, device=sq.device)
    return q8, sq, k8, sk, v8, sv


def flash_mma_q8_plain(q8, sq, k8, sk, v8, sv, spec=None, kv_valid=None, q_offset=0,
                       causal=True, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of the kernel on its operands, step by step as
    ``_kernel_1kv_q8``: s = float(int32 q8.k8) * sq * sk, masked; m the row
    max; p = exp2(s - m); l = sum p in f32; acc = bf16(p * sv) . v8 in f32;
    acc / l, or 0 for a row with no allowed key. (B, T, H, D) in
    ``out_dtype``."""
    b, t, h, d = q8.shape
    s_len = k8.shape[1]
    # int8 products summed in f64 are exact (|sum| <= 127^2 * D < 2^53)
    s32 = torch.einsum("bthd,bshd->bhts", q8.double(), k8.double()).float()
    s = s32 * sq.permute(0, 2, 1)[..., None] * sk.permute(0, 2, 1)[:, :, None, :]
    ok = attention_mask(b, t, s_len, q8.device, spec if causal else None, kv_valid, q_offset,
                        causal)
    s = s.masked_fill(~ok, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    live = m > float("-inf")
    p = torch.exp2(s - torch.where(live, m, 0.0))
    l = p.sum(dim=-1, keepdim=True)
    pv = (p * sv.permute(0, 2, 1)[:, :, None, :]).to(torch.bfloat16).float()
    acc = torch.einsum("bhts,bshd->bhtd", pv, v8.float())
    out = torch.where(live, acc / torch.where(live, l, 1.0), 0.0)
    return out.permute(0, 2, 1, 3).to(out_dtype)


def flash_mma_attention_q8_reference(q, k, v, spec=None, kv_valid=None, q_offset=0,
                                     causal=True, scale=None) -> torch.Tensor:
    """Plain version of :func:`flash_mma_attention_q8`, its routing included."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if routes_to_flash(q, k):
        return flash_mma_attention_reference(q, k, v, spec, kv_valid, q_offset, causal, scale)
    return flash_mma_q8_plain(*quantize_operands(q, k, v, scale), spec, kv_valid, q_offset,
                              causal, q.dtype)


def smem_bytes(nc: int, n_tiles: int, stages: int) -> int:
    """The kernel's dynamic shared bytes (``layout(...).total``): Q, the
    resident K tiles, the V ring (int8 and bf16 tiles), the key scales and
    validity bits, the mbarriers, the image coordinates, and 1024 bytes of
    alignment."""
    scales = (nc + n_tiles + 3 * stages) * TILE_BYTES
    bars = scales + n_tiles * 64 * 4 * 2 + n_tiles * 8
    return 1024 + bars + (1 + MAX_TILES + 3 * stages) * 8 + 3 * MAX_IMAGES * 4


def q8_plan(b: int, t: int, s: int, h: int, sms: int) -> dict:
    """The launch plan of the kernel (``csrc/flash_mma_q8.cu:plan``) for
    ``b`` x ``t`` query rows, ``s`` keys and ``h`` heads on ``sms`` SMs:
    ``rows`` per block (192, three consumer warpgroups, once
    B*H*ceil(T/192) fills two waves; else 64), V ring ``stages`` (3 where
    they fit beside the resident K, else 2), ``smem`` bytes."""
    nc = 3 if b * h * -(-t // 192) >= 2 * sms else 1
    n_tiles = -(-s // 64)
    stages = 3 if smem_bytes(nc, n_tiles, 3) <= MAX_SMEM else 2
    return {"rows": 64 * nc, "stages": stages, "smem": smem_bytes(nc, n_tiles, stages)}


def q8_blocks(plan: dict, b: int, t: int, h: int, causal: bool) -> list[tuple[int, int, int]]:
    """The kernel's blocks in launch order (blockIdx x fastest, then y, z):
    (first query row, head, batch row). The query tiles of one (head, batch
    row) are neighbours; causal puts the last (longest KV walk) first."""
    rows = plan["rows"]
    nq = -(-t // rows)
    return [((nq - 1 - x if causal else x) * rows, y, z)
            for z in range(b) for y in range(h) for x in range(nq)]


def row_stride(h: int, d: int) -> int:
    """Bytes between tokens in the int8 operands the kernel reads: H*D, or
    H*D padded to a multiple of 16 and at least 128 (TMA's stride and box)."""
    return max(128, -(-h * d // 16) * 16)


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("flash_mma_q8")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_mma_q8.argtypes = [p] * 12 + [i] * 8 + [p]
        lib.flash_mma_q8.restype = i
        lib.flash_mma_q8_error_string.argtypes = [i]
        lib.flash_mma_q8_error_string.restype = ctypes.c_char_p
        lib.flash_mma_q8_plan.argtypes = [i] * 4 + [p]
        lib.flash_mma_q8_plan.restype = i
        lib.flash_mma_q8_count_tiles.argtypes = [p]
        lib.flash_mma_q8_count_tiles.restype = None
        _lib = lib
    return _lib


def kernel_plan(b: int, t: int, s: int, h: int) -> dict:
    """The plan the kernel takes on the current CUDA device (C entry
    ``flash_mma_q8_plan``), in :func:`q8_plan`'s keys."""
    out = (ctypes.c_int * 3)()
    lib = _kernel_lib()
    rc = lib.flash_mma_q8_plan(b, t, s, h, out)
    if rc != 0:
        raise RuntimeError("flash_mma_q8_plan failed: "
                           + lib.flash_mma_q8_error_string(rc).decode())
    return {"rows": out[0], "stages": out[1], "smem": out[2]}


@contextlib.contextmanager
def count_q8_tiles(device="cuda"):
    """For checks: while open, every launch of the kernel adds the tiles
    its consumer warpgroups ran in each pass, by class, to the int32 (2, 3)
    tensor yielded (rows: the max pass, the P.V pass; columns ``[skip,
    full, partial]``, in the units of ``flash_mma_args.tile_classes``, 64
    query rows x 64 keys, summed over heads, batch rows and query tiles).
    One atomic per tile; read the tensor after the launches."""
    counts = torch.zeros(PASSES, 3, dtype=torch.int32, device=device)
    lib = _kernel_lib()
    lib.flash_mma_q8_count_tiles(counts.data_ptr())
    try:
        yield counts
    finally:
        lib.flash_mma_q8_count_tiles(None)


def _padded_rows(x: torch.Tensor, ld: int) -> torch.Tensor:
    """(B, L, H, D) int8 as (B, L, ld) rows, zero past H*D (a view when
    ld == H*D, else a copy)."""
    b, n, h, d = x.shape
    if ld == h * d:
        return x.view(b, n, ld)
    out = x.new_zeros(b, n, ld)
    out[..., :h * d] = x.reshape(b, n, h * d)
    return out


def flash_mma_q8_forward(q8, sq, k8, sk, v8, sv, spec=None, kv_valid=None, q_offset=0,
                         causal=True) -> torch.Tensor:
    """The kernel on CUDA operands (counted in
    ``flash_mma_attention_q8.launches``): q8 (B,T,H,D), k8/v8 (B,S,H,D)
    int8; sq (B,T,H), sk/sv (B,S,H) f32. Returns (B, T, H, D) bf16."""
    if q8.dim() != 4 or k8.dim() != 4 or k8.shape != v8.shape:
        raise ValueError(f"flash_mma_q8: q8 (B,T,H,D) and k8, v8 (B,S,H,D) expected, got "
                         f"{tuple(q8.shape)}, {tuple(k8.shape)}, {tuple(v8.shape)}")
    b, t, h, d = q8.shape
    s_len = k8.shape[1]
    if k8.shape[0] != b or k8.shape[2:] != (h, d):
        raise ValueError(f"flash_mma_q8: k8/v8 {tuple(k8.shape)} do not fit q8 {tuple(q8.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_mma_q8: the kernel takes head dims {HEAD_DIMS}, got {d}")
    if s_len > ONE_TILE:
        raise ValueError(f"flash_mma_q8: the kernel keeps at most {ONE_TILE} keys, got {s_len}")
    if q8.device.type != "cuda":
        raise ValueError(f"flash_mma_q8: no kernel for device {q8.device}")
    for name, x, dt, shape in (("q8", q8, torch.int8, None), ("k8", k8, torch.int8, None),
                               ("v8", v8, torch.int8, None),
                               ("sq", sq, torch.float32, (b, t, h)),
                               ("sk", sk, torch.float32, (b, s_len, h)),
                               ("sv", sv, torch.float32, (b, s_len, h))):
        if x.device != q8.device:
            raise ValueError(f"flash_mma_q8: {name} on {x.device}, q8 on {q8.device}")
        if x.dtype != dt:
            raise TypeError(f"flash_mma_q8: {name} must be {dt}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"flash_mma_q8: {name} shape {tuple(x.shape)}, want {shape}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_mma_q8: {name} must be contiguous and 16-byte aligned")
    valid, offset, coords, n_img = kernel_mask_args(spec, kv_valid, q_offset, b, s_len,
                                                    q8.device)
    ld = row_stride(h, d)
    q8, k8, v8 = (_padded_rows(x, ld) for x in (q8, k8, v8))
    out = torch.empty((b, t, h, d), dtype=torch.bfloat16, device=q8.device)
    lib = _kernel_lib()
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(q8.device):
        rc = lib.flash_mma_q8(
            ptr(q8), ptr(k8), ptr(v8), ptr(sq), ptr(sk), ptr(sv), ptr(out), ptr(valid),
            ptr(offset), *(ptr(c) for c in coords), n_img, b, t, s_len, h, d, ld, int(causal),
            torch.cuda.current_stream(q8.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError("flash_mma_q8 launch failed: "
                           + lib.flash_mma_q8_error_string(rc).decode())
    flash_mma_attention_q8.launches += 1
    return out


def flash_mma_attention_q8(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    spec: MMASpec | None = None,
    kv_valid: torch.Tensor | None = None,
    q_offset: torch.Tensor | int = 0,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Flash MMA forward with int8 q/k/v (inference only).

    q (B, T, H, D); k, v (B, S, Hkv, D); other arguments as
    :func:`~aki_torch.ops.flash_mma.flash_mma_attention`. Returns
    (B, T, H, D) in q's dtype. GQA and sequences past one 1024 tile go to
    ``flash_mma_attention``, as in JAX. Otherwise CUDA tensors (bf16, D in
    ``flash_mma_args.HEAD_DIMS``) launch the int8 kernel and nothing else;
    CPU tensors take the plain version.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_mma_attention_q8_reference(q, k, v, spec, kv_valid, q_offset, causal,
                                                scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mma_q8: no kernel for device {q.device}")
    if routes_to_flash(q, k):
        return flash_mma_attention(q, k, v, spec=spec, kv_valid=kv_valid, q_offset=q_offset,
                                   causal=causal, scale=scale)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError("flash_mma_q8: inference only, the kernel has no backward")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_mma_q8: the kernel writes bf16, q is {q.dtype}")
    return flash_mma_q8_forward(*quantize_operands(q, k, v, scale), spec, kv_valid, q_offset,
                                causal)


flash_mma_attention_q8.launches = 0

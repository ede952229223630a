"""Decode attention over the int8 KV cache in the flat layout (counterpart of
``aki_tpu/ops/decode_attention.py``).

The cache of int8-KV serving is flat: int8 ``(L, B, S, Hkv*D)`` (all heads
of a token in one row) with token-major f32 per-(token, head) scales
``(L, B, S, Hkv)``. :func:`quantize_kv_flat` makes its rows;
:func:`decode_attention_flat` attends one query token over one layer of it.

:func:`decode_attention_flat` holds the numerics of the JAX package's
default for this step, ``decode_attention_flat_xla``: q rounded to bf16,
the int8 K and V exact in f32, f32 scores times the K scales times the
softmax scale, the prefix of ``lengths[b]`` keys valid, an f32 softmax,
``p * vs`` rounded to bf16 and the PV product summed in f32. On CUDA
tensors it launches the CUDA C++ kernel of ``csrc/decode_attention.cu``
(which replaces the TPU kernel ``decode_attention.py:70 _kernel``; its
header says what bounds it) and counts the launch in
``decode_attention_flat.launches``; it raises on what the kernel does not
take and never falls back. On CPU tensors it runs the plain version,
:func:`decode_attention_flat_reference`.

The kernel splits each (head, row) over a cluster of C blocks: the
wrapper picks C with :func:`cluster_size`, block r takes the keys of
:func:`key_range`, and :func:`decode_attention_flat_split_reference`
computes the same function in the kernel's order of sums (per-block
scores, the cluster's max and sum, per-block f32 partials summed in rank
order).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

NEG_INF = -1e30
MAX_HEAD_DIM = 128          # the kernel's head dims: multiples of 16 up to 128
CLUSTER_SIZES = (1, 2, 4, 8)   # blocks per (head, row); 8 is the portable cluster
SMEM_LIMIT = 232448 - (4 + 2 + 128) * 4   # dynamic shared memory of a block, H100
_THREADS = 128
_lib = None
_sms: dict[int, int] = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tile_keys(d: int) -> int:
    """Keys of one ring stage: 128 threads, two to a key where D % 32 == 0."""
    return _THREADS // (2 if d % 32 == 0 else 1)


def smem_bytes(s_len: int, c: int, d: int) -> int:
    """Dynamic shared memory of one block (``decode_attention.cu:smem_bytes``):
    a ring of 4 key tiles, and the scores and V scales of a share of
    ceil(S / C) keys rounded up to whole tiles."""
    tk = _tile_keys(d)
    share = _cdiv(_cdiv(s_len, c), tk) * tk
    return 4 * tk * d + 2 * share * 4


def cluster_size(pairs: int, sms: int, s_len: int, d: int) -> int:
    """Blocks per (head, row) for ``pairs`` = live rows x heads on a card of
    ``sms`` SMs: the least C that gives two waves of blocks (pairs * C >=
    2 * sms) among the sizes whose shared memory fits, else the largest
    that fits."""
    fits = [c for c in CLUSTER_SIZES if smem_bytes(s_len, c, d) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"decode attention kernel: {s_len} slots do not fit a cluster of "
                         f"{CLUSTER_SIZES[-1]} blocks")
    return next((c for c in fits if pairs * c >= 2 * sms), fits[-1])


def key_range(n: int, c: int, rank: int) -> tuple[int, int]:
    """Keys [start, stop) of the live prefix of ``n`` keys that block
    ``rank`` of a cluster of ``c`` takes (``decode_attention.cu``)."""
    n = max(n, 0)
    share = _cdiv(n, c)
    start = min(rank * share, n)
    return start, min(start + share, n)


def quantize_kv_flat(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 over the head dim, flat layout:
    (B, T, H, D) -> (int8 (B, T, H*D), scales f32 (B, T, H))."""
    b, t, h, d = x.shape
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = torch.where(amax == 0, 1.0, amax / 127.0)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return q.reshape(b, t, h * d), scale


def decode_attention_flat_reference(q, k, ks, v, vs, lengths, layer: int,
                                    scale: float | None = None,
                                    live_width: int | None = None) -> torch.Tensor:
    """Plain version, the counterpart of ``decode_attention_flat_xla``
    (``aki_tpu/ops/decode_attention.py:359-460``) written per head: the
    block-diagonal Q and selector products there compute the same sums
    with zero off-diagonal terms.

    q (B, 1, H, D); k, v int8 (L, B, S, Hkv*D); ks, vs f32 (L, B, S, Hkv);
    lengths (B,) live keys per row; ``layer`` the cache layer. Rows past
    ``live_width`` come back zero, and so does a row with length 0 (the
    kernel's contract; the XLA form would average the whole row there).
    Returns (B, 1, H, D) in q's dtype.
    """
    b_full, _, h, d = q.shape
    s_len, hkv = ks.shape[2], ks.shape[3]
    if h % hkv or k.shape[-1] != hkv * d:
        raise ValueError(f"decode attention: q {tuple(q.shape)} does not fit a cache row "
                         f"of {k.shape[-1]} with {hkv} KV heads")
    group = h // hkv
    if scale is None:
        scale = d ** -0.5
    b = b_full if live_width is None else min(live_width, b_full)
    lengths = lengths[:b]

    qh = q[:b].reshape(b, h, d).to(torch.bfloat16).float()
    k_li = k[layer, :b].reshape(b, s_len, hkv, d).float().repeat_interleave(group, dim=2)
    v_li = v[layer, :b].reshape(b, s_len, hkv, d).float().repeat_interleave(group, dim=2)
    ks_li = ks[layer, :b].permute(0, 2, 1).repeat_interleave(group, dim=1)   # (b, H, S)
    vs_li = vs[layer, :b].permute(0, 2, 1).repeat_interleave(group, dim=1)

    s = torch.einsum("bhd,bshd->bhs", qh, k_li) * ks_li * scale
    ok = torch.arange(s_len, device=q.device)[None, None, :] < lengths[:, None, None]
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    pv = (p * vs_li).to(torch.bfloat16).float()
    o = torch.einsum("bhs,bshd->bhd", pv, v_li)
    o = torch.where((lengths > 0)[:, None, None], o, 0.0)
    out = torch.zeros((b_full, 1, h, d), dtype=q.dtype, device=q.device)
    out[:b, 0] = o.to(q.dtype)
    return out


def decode_attention_flat_split_reference(q, k, ks, v, vs, lengths, layer: int,
                                          scale: float | None = None,
                                          live_width: int | None = None,
                                          cluster: int = 1) -> torch.Tensor:
    """The function of :func:`decode_attention_flat_reference` summed in the
    kernel's order: each row's live keys split by :func:`key_range` over
    ``cluster`` blocks; each block's scores and max, the cluster's max, each
    block's sum of exp, the cluster's sum (rank order); bf16(p * vs) from
    the cluster's (max, sum); each block's P V in f32, the partials summed
    in rank order. Same arguments and result as the plain version."""
    b_full, _, h, d = q.shape
    s_len, hkv = ks.shape[2], ks.shape[3]
    if h % hkv or k.shape[-1] != hkv * d:
        raise ValueError(f"decode attention: q {tuple(q.shape)} does not fit a cache row "
                         f"of {k.shape[-1]} with {hkv} KV heads")
    group = h // hkv
    if scale is None:
        scale = d ** -0.5
    rows = b_full if live_width is None else min(live_width, b_full)
    out = torch.zeros((b_full, 1, h, d), dtype=q.dtype, device=q.device)
    for b in range(rows):
        n = min(max(int(lengths[b]), 0), s_len)
        if n == 0:
            continue
        qh = q[b, 0].to(torch.bfloat16).float()                                  # (H, D)
        kb = k[layer, b, :n].reshape(n, hkv, d).float().repeat_interleave(group, 1)
        vb = v[layer, b, :n].reshape(n, hkv, d).float().repeat_interleave(group, 1)
        ksb = ks[layer, b, :n].repeat_interleave(group, 1)                        # (n, H)
        vsb = vs[layer, b, :n].repeat_interleave(group, 1)
        spans = [key_range(n, cluster, r) for r in range(cluster)]
        scores = [torch.einsum("hd,jhd->hj", qh, kb[j0:j1]) * ksb[j0:j1].T * scale
                  for j0, j1 in spans]
        m = torch.full((h,), -torch.inf, device=q.device)
        for sc in scores:
            if sc.shape[1]:
                m = torch.maximum(m, sc.amax(1))
        e = [torch.exp(sc - m[:, None]) for sc in scores]
        total = torch.zeros(h, device=q.device)
        for ej in e:
            total = total + ej.sum(1)
        o = torch.zeros(h, d, device=q.device)
        for (j0, j1), ej in zip(spans, e):
            pv = (ej / total[:, None] * vsb[j0:j1].T).to(torch.bfloat16).float()
            o = o + torch.einsum("hj,jhd->hd", pv, vb[j0:j1])
        out[b, 0] = o.to(q.dtype)
    return out


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("decode_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention.argtypes = [p] * 7 + [i] * 8 + [ctypes.c_float, i, p]
        lib.decode_attention.restype = i
        lib.decode_attention_smem_bytes.argtypes = [i, i, i]
        lib.decode_attention_smem_bytes.restype = ctypes.c_longlong
        lib.decode_attention_error_string.argtypes = [i]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def _check(q, k, ks, v, vs, lengths, layer):
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or ks.dim() != 4:
        raise ValueError(f"decode attention: q (B,1,H,D), k (L,B,S,F), ks (L,B,S,Hkv) "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(ks.shape)}")
    b, _, h, d = q.shape
    n_layers, bc, s_len, hkv = ks.shape
    if (k.shape != v.shape or ks.shape != vs.shape or k.shape[:3] != ks.shape[:3]
            or k.shape[3] != hkv * d or bc != b or h % hkv):
        raise ValueError(f"decode attention: cache {tuple(k.shape)} / scales {tuple(ks.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    if d % 16 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"decode attention kernel takes head dims that are multiples of 16 "
                         f"up to {MAX_HEAD_DIM}, got {d}")
    if not 0 <= layer < n_layers:
        raise IndexError(f"decode attention: layer {layer} of {n_layers}")
    if lengths.shape != (b,):
        raise ValueError(f"decode attention: lengths {tuple(lengths.shape)}, want ({b},)")
    for name, x, dt in (("k", k, torch.int8), ("v", v, torch.int8),
                        ("ks", ks, torch.float32), ("vs", vs, torch.float32)):
        if x.device != q.device:
            raise ValueError(f"decode attention: {name} on {x.device}, q on {q.device}")
        if x.dtype != dt:
            raise TypeError(f"decode attention kernel: {name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"decode attention kernel: {name} must be contiguous, 16-byte aligned")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"decode attention kernel: q must be bf16, got {q.dtype}")


def decode_attention_flat(q, k, ks, v, vs, lengths, layer: int,
                          scale: float | None = None,
                          live_width: int | None = None) -> torch.Tensor:
    """Single-token attention over layer ``layer`` of the flat int8 cache.

    q (B, 1, H, D); k, v int8 (L, B, S, Hkv*D); ks, vs f32 (L, B, S, Hkv);
    lengths (B,) live tokens of each row, the just-written one included;
    only the first ``live_width`` rows are read (the server's tail
    compaction), the others come back zero. GQA through H % Hkv == 0.
    Returns (B, 1, H, D) in q's dtype; the kernel takes bf16 q only.
    """
    if q.device.type == "cpu":
        return decode_attention_flat_reference(q, k, ks, v, vs, lengths, layer, scale,
                                               live_width)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention: no kernel for device {q.device}")
    _check(q, k, ks, v, vs, lengths, layer)
    b, _, h, d = q.shape
    n_layers, _, s_len, hkv = ks.shape
    if scale is None:
        scale = d ** -0.5
    rows = b if live_width is None else min(live_width, b)
    if rows <= 0:
        raise ValueError(f"decode attention: live_width {live_width}")
    qb = q.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    cluster = cluster_size(rows * h, _sm_count(q.device), s_len, d)
    out = (torch.empty if rows == b else torch.zeros)(q.shape, dtype=q.dtype, device=q.device)
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        rc = lib.decode_attention(
            qb.data_ptr(), k.data_ptr(), ks.data_ptr(), v.data_ptr(), vs.data_ptr(),
            lens.data_ptr(), out.data_ptr(), int(layer),
            n_layers, b, rows, s_len, h, hkv, d, float(scale), cluster,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("decode_attention launch failed: "
                           + lib.decode_attention_error_string(rc).decode())
    decode_attention_flat.launches += 1
    return out


decode_attention_flat.launches = 0

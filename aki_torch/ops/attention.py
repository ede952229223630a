"""Dense attention (counterpart of ``aki_tpu/ops/attention.py:dense_attention``).

The plain oracle for the flash kernel and the decode path (one query row):
softmax(QK^T * scale + mask) V with f32 logits, f32 softmax and the
probabilities cast to V's dtype before the PV product, as the JAX oracle does.
"""

from __future__ import annotations

import torch

from .masks import MMASpec, allowed_mask


def attention_mask(
    b: int, t: int, s: int, device,
    spec: MMASpec | None = None,
    kv_valid: torch.Tensor | None = None,
    q_offset: torch.Tensor | int = 0,
    causal: bool = True,
) -> torch.Tensor:
    """(B, 1, T, S) bool, True = may attend, under ``kv_valid``: the MMA
    rule of ``spec``; plain causal when ``spec`` is None and ``causal``; all
    keys when ``spec`` is None and not ``causal``."""
    if spec is None and causal:
        spec = MMASpec(*(torch.zeros((b,), dtype=torch.int32, device=device),) * 3)
    if spec is not None:
        return allowed_mask(spec, t, s, kv_valid, q_offset)[:, None]
    ok = torch.ones((b, 1, t, s), dtype=torch.bool, device=device)
    if kv_valid is not None:
        ok = ok & (kv_valid[:, None, None, :] != 0)
    return ok


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    spec: MMASpec | None = None,
    kv_valid: torch.Tensor | None = None,
    q_offset: torch.Tensor | int = 0,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Reference multi-head attention.

    Args:
        q: (B, T, H, D)
        k, v: (B, S, Hkv, D) — Hkv may divide H (GQA: K/V are repeated).
        spec: MMA block spec; ``None`` with ``causal=True`` gives plain
            causal, ``None`` with ``causal=False`` gives full attention.
        kv_valid: (B, S) 0/1 key validity.
        q_offset: absolute position of q[0] (scalar or (B,)).

    Returns:
        (B, T, H, D) in q.dtype. Rows with no allowed key are 0. Math in
        f32 (f64 for f64 inputs).
    """
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    if hkv != h:
        if h % hkv:
            raise ValueError(f"{h} query heads do not group over {hkv} KV heads")
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)

    # bf16 x bf16 products are exact in f32: upcasting first gives the
    # f32-accumulated dot of the JAX oracle
    acc = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("bthd,bshd->bhts", q.to(acc), k.to(acc)) * scale
    ok = attention_mask(b, t, s, q.device, spec, kv_valid, q_offset, causal)
    logits = logits.masked_fill(~ok, torch.finfo(acc).min)
    probs = torch.softmax(logits, dim=-1)
    # rows with no allowed key would softmax over all -inf: give 0, not NaN
    probs = torch.where(ok.any(dim=-1, keepdim=True), probs, 0.0)
    out = torch.einsum("bhts,bshd->bthd", probs.to(v.dtype).to(acc), v.to(acc))
    return out.to(q.dtype)

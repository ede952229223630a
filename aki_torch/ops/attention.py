"""Dense attention (counterpart of ``aki_tpu/ops/attention.py:dense_attention``).

The plain oracle for the flash kernel and the decode path (one query row):
softmax(QK^T * scale + mask) V with f32 logits, f32 softmax and the
probabilities cast to V's dtype before the PV product, as the JAX oracle does.
Beside it, the bf16-probability attentions of the quantized serving prefill
(``decoder_attention_bf16p``, ``encoder_attention_bf16p``), plain torch as
their JAX counterparts are plain XLA.
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


def _bf16p_attention(q, k, v, ok, scale):
    """softmax(QK^T * scale) V with the probabilities rounded to bf16 and
    divided, after the PV product, by the f32 sum of the rounded values;
    ``ok`` (B, 1, T, S) bool or None (all keys)."""
    h, hkv = q.shape[2], k.shape[2]
    if hkv != h:
        if h % hkv:
            raise ValueError(f"{h} query heads do not group over {hkv} KV heads")
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    # bf16 x bf16 products are exact in f32: the f32-accumulated einsum
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if ok is not None:
        s = s.masked_fill(~ok, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).to(torch.bfloat16)
    denom = p.float().sum(dim=-1, keepdim=True)
    o = torch.einsum("bhts,bshd->bthd", p.float(), v.float())
    o = o / denom.permute(0, 2, 1, 3)
    if ok is not None:
        # a row with no allowed key has m == -1e30 and every p == 1: zero it
        o = torch.where(ok.any(dim=-1).permute(0, 2, 1)[..., None], o, 0.0)
    return o.to(q.dtype)


def decoder_attention_bf16p(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    spec: MMASpec | None = None,
    kv_valid: torch.Tensor | None = None,
    q_offset: torch.Tensor | int = 0,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Causal / MMA prefill attention with bf16 probabilities: the
    counterpart of ``aki_tpu/ops/attention.py:decoder_attention_xla``, the
    attention of the quantized serving prefill. The mask arguments are
    those of :func:`dense_attention`; f32 scores, ``p = exp(s - max)``
    rounded to bf16, the PV product in f32 divided by the f32 sum of the
    rounded ``p``; rows with no allowed key give 0. (B, T, H, D) in q's
    dtype."""
    b, t, _, d = q.shape
    if scale is None:
        scale = d ** -0.5
    ok = attention_mask(b, t, k.shape[1], q.device, spec, kv_valid, q_offset, causal)
    return _bf16p_attention(q, k, v, ok, scale)


def encoder_attention_bf16p(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float | None = None) -> torch.Tensor:
    """Full (non-causal, unmasked) attention with bf16 probabilities: the
    counterpart of ``aki_tpu/ops/attention.py:encoder_attention_xla``, the
    vision tower's attention under quantized weights on the card.
    (B, T, H, D) -> (B, T, H, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _bf16p_attention(q, k, v, None, scale)

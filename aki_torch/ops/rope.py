"""Rotary position embeddings with Phi-3.5 LongRoPE support
(counterpart of ``aki_tpu/ops/rope.py``).

Neox-style rotate-half over the full head dim. LongRoPE divides the inverse
frequencies by per-frequency factors and multiplies cos/sin by
``RopeConfig.attention_scaling``; the short factors apply at every length.
"""

from __future__ import annotations

import torch

from ..models.configs import RopeConfig


def rope_cos_sin(cfg: RopeConfig, positions: torch.Tensor):
    """cos/sin tables ``(..., T, head_dim)`` in f32 for int ``positions``
    ``(..., T)``; LongRoPE's short factors, when the config has them."""
    half = cfg.head_dim // 2
    dev = positions.device
    freqs = torch.arange(0, half, dtype=torch.float32, device=dev)
    inv_freq = 1.0 / (cfg.theta ** (2.0 * freqs / cfg.head_dim))
    if cfg.short_factor is not None:
        inv_freq = inv_freq / torch.tensor(cfg.short_factor, dtype=torch.float32,
                                           device=dev)
    angles = positions.to(torch.float32)[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    scaling = cfg.attention_scaling
    return torch.cos(angles) * scaling, torch.sin(angles) * scaling


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (B, T, H, D) by tables ``(B, T, D)`` or ``(T, D)``; the
    product is taken in f32 and cast back to ``x.dtype``."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    out = x.float() * cos + _rotate_half(x).float() * sin
    return out.to(x.dtype)

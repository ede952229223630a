"""Token samplers: greedy, temperature, top-k / top-p (counterpart of
``aki_tpu/infer/sampling.py``). Random draws come from an explicit
``torch.Generator``, so sampled tokens differ from the JAX package's; the
masks agree."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0      # 0 => greedy
    top_k: int = 0                # 0 => disabled
    top_p: float = 1.0            # 1 => disabled


def filter_logits(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """Temperature-scaled f32 logits with the tokens outside top-k / top-p
    set to -inf (top-p keeps the smallest set whose probability reaches
    ``top_p``, and always the top token)."""
    logits = logits.float() / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = probs.cumsum(dim=-1) - probs < cfg.top_p
        threshold = torch.where(keep, sorted_logits, float("inf")).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < threshold, float("-inf"))
    return logits


def sample(logits: torch.Tensor, cfg: SamplingConfig,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """Next ids ``(B,)`` from ``(B, V)`` logits."""
    if cfg.temperature <= 0.0:
        return logits.argmax(dim=-1)
    probs = torch.softmax(filter_logits(logits, cfg), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]

"""Decoupled embedding + LM head for the framework-added special tokens
(counterpart of ``aki_tpu/models/embeddings.py``).

The backbone's table is never resized: ids at or above
``initial_tokenizer_len`` route to a small extra table, and the head
truncates the backbone logits to ``initial_tokenizer_len`` before appending
the extra columns. Parameter names follow the reference checkpoint
(``embed_tokens.weight`` / ``.additional_embedding.weight``,
``lm_head.weight`` / ``.bias`` / ``.additional_fc.*``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import empty


class DecoupledEmbedding(nn.Module):
    def __init__(self, vocab: int, num_extra: int, hidden: int, *, device, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab, hidden, device=device, dtype=dtype))
        self.additional_embedding = empty(nn.Embedding, num_extra, hidden,
                                          device=device, dtype=dtype)


class DecoupledLinear(nn.Module):
    """Base head ``(vocab, hidden)`` with bias, plus the extra head
    ``additional_fc`` — both biased, as the reference builds them."""

    def __init__(self, hidden: int, vocab: int, num_extra: int, *, device, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab, hidden, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(vocab, device=device, dtype=dtype))
        self.additional_fc = empty(nn.Linear, hidden, num_extra, bias=True,
                                   device=device, dtype=dtype)


def decoupled_lookup(base_table: torch.Tensor, extra_table: torch.Tensor,
                     ids: torch.Tensor, initial_tokenizer_len: int) -> torch.Tensor:
    """Embed ids; ids >= initial_tokenizer_len hit the extra table. Indices
    clamp into range, like JAX's ``mode="clip"`` gathers (an out-of-range id
    would otherwise be a device-side assert on the card)."""
    is_extra = ids >= initial_tokenizer_len
    base_ids = torch.where(is_extra, 0, ids).clamp(0, base_table.shape[0] - 1)
    extra_ids = torch.where(is_extra, ids - initial_tokenizer_len, 0).clamp(
        0, extra_table.shape[0] - 1)
    base = F.embedding(base_ids, base_table)
    extra = F.embedding(extra_ids, extra_table).to(base.dtype)
    return torch.where(is_extra[..., None], extra, base)


def decoupled_logits(hidden: torch.Tensor, head_w: torch.Tensor,
                     extra_w: torch.Tensor, initial_tokenizer_len: int,
                     head_b: torch.Tensor | None = None,
                     extra_b: torch.Tensor | None = None) -> torch.Tensor:
    """Logits over ``initial_tokenizer_len + num_extra`` ids. ``head_w``
    ``(vocab, hidden)`` is truncated to the live vocab before the matmul;
    the biases add after the product, cast to its dtype."""
    base = hidden @ head_w[:initial_tokenizer_len].T
    if head_b is not None:
        base = base + head_b[:initial_tokenizer_len].to(base.dtype)
    extra = hidden @ extra_w.T
    if extra_b is not None:
        extra = extra + extra_b.to(extra.dtype)
    return torch.cat([base, extra], dim=-1)

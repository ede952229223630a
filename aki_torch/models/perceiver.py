"""Perceiver resampler: patch features -> a fixed number of vision tokens
(counterpart of ``aki_tpu/models/perceiver.py:perceiver_forward``).

Per block: latent cross-attention whose K/V span ``concat(media, latents)``
with separate pre-norms for media and latents and a stabilised softmax,
residual to the un-normed latents; then a LayerNorm-first FF (exact GELU,
bias-free projections) with residual. A final LayerNorm and a biased
projection to the LM width close it. The (latents x media) attention is a
plain einsum here, as in JAX. Parameter names follow the reference
checkpoint's ``vision_tokenizer.*``: ``layers.{i}.0`` is the attention,
``layers.{i}.1`` the FF as ``Sequential(LayerNorm, Linear, GELU, Linear)``.

Under tensor parallelism (``tp``, :mod:`aki_torch.parallel.tensor`) each
rank holds its heads of to_q and to_kv and its columns of the first FF
product and of the projection, Megatron-style; the block stays
differentiable.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.tensor import column_parallel, row_parallel
from .common import (BF16, Policy, empty, init_const, init_norm, init_normal,
                     layernorm, remat_call)
from .configs import PerceiverConfig


class PerceiverAttention(nn.Module):
    def __init__(self, cfg: PerceiverConfig, *, device, dtype):
        super().__init__()
        d, inner = cfg.dim, cfg.dim_head * cfg.heads
        kw = dict(device=device, dtype=dtype)
        self.norm_media = empty(nn.LayerNorm, d, **kw)
        self.norm_latents = empty(nn.LayerNorm, d, **kw)
        self.to_q = empty(nn.Linear, d, inner, bias=False, **kw)
        self.to_kv = empty(nn.Linear, d, 2 * inner, bias=False, **kw)
        self.to_out = empty(nn.Linear, inner, d, bias=False, **kw)

    def forward(self, x, latents, cfg: PerceiverConfig, policy: Policy, tp=None):
        """``tp``: the Perceiver's :class:`~aki_torch.parallel.tensor.TensorParallel`
        (the weights hold the rank's heads; to_out's partial products are
        summed over the group)."""
        b = x.shape[0]
        h, dh = cfg.heads // (1 if tp is None else tp.size), cfg.dim_head
        cast = policy.cast
        xm = layernorm(cast(self.norm_media.weight), cast(self.norm_media.bias), x)
        ln_lat = layernorm(cast(self.norm_latents.weight),
                           cast(self.norm_latents.bias), latents)
        kv_in = torch.cat([xm, ln_lat], dim=1)
        q = column_parallel(self.to_q, ln_lat, policy, tp)
        kv = column_parallel(self.to_kv, kv_in, policy, tp)
        q = q.reshape(b, -1, h, dh)
        k, v = kv.chunk(2, dim=-1)
        k = k.reshape(b, -1, h, dh)
        v = v.reshape(b, -1, h, dh)
        logits = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * dh ** -0.5
        logits = logits - logits.amax(dim=-1, keepdim=True)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhij,bjhd->bihd", probs.float(), v.float()).to(latents.dtype)
        out = out.reshape(b, -1, h * dh)
        return row_parallel(self.to_out, out, policy, tp)


class PerceiverBlock(nn.Module):
    """The attention and the feed-forward of one block (the reference's
    ``layers.{i}.0`` / ``.1`` names) as one module with a forward, so that a
    sharded block (an FSDP2 unit) gathers its weights around it."""

    def __init__(self, attn: nn.Module, ff: nn.Module):
        super().__init__()
        self.add_module("0", attn)
        self.add_module("1", ff)

    def __iter__(self):
        return iter((self._modules["0"], self._modules["1"]))

    def forward(self, x, latents, cfg: PerceiverConfig, policy: Policy,
                tp=None) -> torch.Tensor:
        attn, ff = self
        cast = policy.cast
        latents = latents + attn(x, latents, cfg, policy, tp)
        f = layernorm(cast(ff[0].weight), cast(ff[0].bias), latents)
        f = column_parallel(ff[1], f, policy, tp)
        f = F.gelu(f.float()).to(f.dtype)
        return latents + row_parallel(ff[3], f, policy, tp)


class PerceiverResampler(nn.Module):
    """``(B, v, dim)`` features -> ``(B, num_latents, dim_inner)`` tokens."""

    def __init__(self, cfg: PerceiverConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        d, ff = cfg.dim, cfg.dim * cfg.ff_mult
        kw = dict(device=device, dtype=dtype)
        self.latents = nn.Parameter(torch.empty(cfg.num_latents, d, **kw))
        self.layers = nn.ModuleList(
            PerceiverBlock(
                PerceiverAttention(cfg, **kw),
                nn.Sequential(empty(nn.LayerNorm, d, **kw),
                              empty(nn.Linear, d, ff, bias=False, **kw),
                              nn.GELU(),
                              empty(nn.Linear, ff, d, bias=False, **kw)))
            for _ in range(cfg.depth))
        self.norm = empty(nn.LayerNorm, d, **kw)
        self.projection = empty(nn.Linear, d, cfg.dim_inner, **kw)
        # set by aki_torch.parallel.tensor.shard_tensor_parallel
        self.tp = None

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The JAX init: latents N(0, 1), weights N(0, 0.02), zero bias,
        identity norms."""
        init_normal(gen, 1.0, self.latents)
        for attn, ff in self.layers:
            init_normal(gen, 0.02, attn.to_q.weight, attn.to_kv.weight,
                        attn.to_out.weight, ff[1].weight, ff[3].weight)
            init_norm(attn.norm_media, attn.norm_latents, ff[0])
        init_norm(self.norm)
        init_normal(gen, 0.02, self.projection.weight)
        init_const(0.0, self.projection.bias)

    def forward(self, features: torch.Tensor, policy: Policy = BF16,
                remat: bool = False, remat_policy: str = "full") -> torch.Tensor:
        """``remat`` recomputes each block in the backward (as the decoder)."""
        cast, tp = policy.cast, self.tp
        x = features.to(policy.compute_dtype)
        latents = cast(self.latents).expand(x.shape[0], -1, -1)
        for block in self.layers:
            latents = remat_call(remat, remat_policy, block, x, latents, self.cfg, policy, tp)
        latents = layernorm(cast(self.norm.weight), cast(self.norm.bias), latents)
        out = column_parallel(self.projection, latents, policy, tp)
        # under tp the rank's output columns (and bias), gathered
        return out if tp is None else tp.gather_last(out)

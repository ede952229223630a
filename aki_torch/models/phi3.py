"""Phi-3-family decoder, bf16/fp32 path (counterpart of
``aki_tpu/models/phi3.py:phi3_forward``).

RMSNorm, fused QKV, neox RoPE with LongRoPE factors, SiLU-gated MLP with a
fused gate/up projection. The forward consumes already-spliced embeddings;
the decoupled embedding and head sit beside it in ``lang_model``. Parameter
names follow the reference checkpoint's ``lang_model.*``.

With a :class:`KVCache`, a prompt of T > 1 tokens is written at slots
``[0, T)`` and attends over the whole cache layer (``max_len`` keys under
``kv_valid``); a decode step (T == 1) writes row ``cache_index[b]`` and
attends the same way. The cache is updated in place.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dense_attention
from ..ops.flash_mma import flash_mma_attention
from ..ops.masks import MMASpec
from ..ops.rope import apply_rope, rope_cos_sin
from .common import BF16, Policy, empty, linear, remat_call, rmsnorm
from .configs import Phi3Config


@dataclasses.dataclass
class KVCache:
    """Stacked per-layer cache ``(L, B, S, H_kv, D_head)``."""

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def create(cfg: Phi3Config, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu") -> "KVCache":
        # zeros, not empty: never-written slots are read (masked) by decode
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device))


def _write_rows(layer_cache: torch.Tensor, new: torch.Tensor,
                pos: torch.Tensor) -> None:
    """``layer_cache[b, pos[b, t]] = new[b, t]``, dropping positions past the
    cache as the JAX scatter's ``mode="drop"`` does — without a host sync:
    out-of-range rows rewrite the value already at the clamped slot."""
    s = layer_cache.shape[1]
    bidx = torch.arange(new.shape[0], device=new.device)[:, None]
    slot = pos.clamp(max=s - 1)
    keep = (pos < s)[..., None, None]
    layer_cache[bidx, slot] = torch.where(keep, new.to(layer_cache.dtype),
                                          layer_cache[bidx, slot])


class Phi3DecoderLayer(nn.Module):
    def __init__(self, cfg: Phi3Config, *, device, dtype):
        super().__init__()
        d, nh, nkv, dh = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = empty(nn.RMSNorm, d, **kw)
        self.self_attn = nn.ModuleDict({
            "qkv_proj": empty(nn.Linear, d, (nh + 2 * nkv) * dh, bias=False, **kw),
            "o_proj": empty(nn.Linear, nh * dh, d, bias=False, **kw),
        })
        self.post_attention_layernorm = empty(nn.RMSNorm, d, **kw)
        self.mlp = nn.ModuleDict({
            "gate_up_proj": empty(nn.Linear, d, 2 * cfg.intermediate_size, bias=False, **kw),
            "down_proj": empty(nn.Linear, cfg.intermediate_size, d, bias=False, **kw),
        })

    def forward(self, x, cos, sin, cfg: Phi3Config, spec, kv_valid, q_offset,
                cache: KVCache | None, li: int, wpos, policy: Policy,
                use_flash: bool):
        b, t, _ = x.shape
        nh, nkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        eps = cfg.rms_norm_eps
        h = rmsnorm(policy.cast(self.input_layernorm.weight), x, eps)
        qkv = linear(self.self_attn["qkv_proj"], h, policy)
        q = qkv[..., : nh * dh].reshape(b, t, nh, dh)
        k = qkv[..., nh * dh: (nh + nkv) * dh].reshape(b, t, nkv, dh)
        v = qkv[..., (nh + nkv) * dh:].reshape(b, t, nkv, dh).contiguous()
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        if cache is not None:
            ck, cv = cache.k[li], cache.v[li]
            if t == 1:
                _write_rows(ck, k, wpos)
                _write_rows(cv, v, wpos)
            else:
                ck[:, :t] = k
                cv[:, :t] = v
            k_att, v_att = ck.to(q.dtype), cv.to(q.dtype)
        else:
            k_att, v_att = k, v

        attend = flash_mma_attention if use_flash else dense_attention
        attn = attend(q, k_att, v_att, spec=spec, kv_valid=kv_valid, q_offset=q_offset)
        x = x + linear(self.self_attn["o_proj"], attn.reshape(b, t, nh * dh), policy)

        h2 = rmsnorm(policy.cast(self.post_attention_layernorm.weight), x, eps)
        gate, up = linear(self.mlp["gate_up_proj"], h2, policy).chunk(2, dim=-1)
        act = F.silu(gate.float()).to(up.dtype) * up
        return x + linear(self.mlp["down_proj"], act, policy)


class Phi3Model(nn.Module):
    """The decoder stack; ``embed_tokens`` is the decoupled embedding,
    applied outside :meth:`forward` (which takes spliced embeddings)."""

    def __init__(self, cfg: Phi3Config, embed_tokens: nn.Module, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = embed_tokens
        self.layers = nn.ModuleList(Phi3DecoderLayer(cfg, device=device, dtype=dtype)
                                    for _ in range(cfg.num_layers))
        self.norm = empty(nn.RMSNorm, cfg.hidden_size, device=device, dtype=dtype)

    def forward(
        self,
        inputs_embeds: torch.Tensor,
        positions: torch.Tensor,
        spec: MMASpec | None = None,
        kv_valid: torch.Tensor | None = None,
        q_offset: torch.Tensor | int = 0,
        cache: KVCache | None = None,
        cache_index: torch.Tensor | None = None,
        policy: Policy = BF16,
        use_flash: bool = True,
        remat: bool = False,
        remat_policy: str = "full",
    ) -> tuple[torch.Tensor, KVCache | None]:
        """Run the stack over ``inputs_embeds`` (B, T, D).

        positions: (B, T) absolute RoPE positions. spec: MMA block spec
        (None = causal). kv_valid: key validity — (B, T) without a cache,
        (B, max_len) over the whole cache buffer with one. q_offset:
        absolute position of the first query row. cache / cache_index: KV
        cache and per-row write offsets (B,).

        Returns (final-normed hidden states (B, T, D), the cache).
        """
        cfg = self.cfg
        x = inputs_embeds.to(policy.compute_dtype)
        cos, sin = rope_cos_sin(cfg.rope, positions)
        wpos = None
        if cache is not None:
            t = x.shape[1]
            wpos = cache_index.to(torch.int64)[:, None] + torch.arange(t, device=x.device)
        remat = remat and cache is None
        for li, layer in enumerate(self.layers):
            x = remat_call(remat, remat_policy, layer, x, cos, sin, cfg, spec, kv_valid,
                           q_offset, cache, li, wpos, policy, use_flash)
        return rmsnorm(policy.cast(self.norm.weight), x, cfg.rms_norm_eps), cache

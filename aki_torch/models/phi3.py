"""Phi-3-family decoder, bf16/fp32 path (counterpart of
``aki_tpu/models/phi3.py:phi3_forward``).

RMSNorm, fused QKV, neox RoPE with LongRoPE factors, SiLU-gated MLP with a
fused gate/up projection. The forward consumes already-spliced embeddings;
the decoupled embedding and head sit beside it in ``lang_model``. Parameter
names follow the reference checkpoint's ``lang_model.*``.

With a :class:`KVCache`, a prompt of T > 1 tokens is written at slots
``[0, T)`` and attends over the whole cache layer (``max_len`` keys under
``kv_valid``); a decode step (T == 1) writes row ``cache_index[b]`` and
attends the same way. With a :class:`KVCacheQ` (int8-KV serving) the
prompt's K/V are quantized and stored, and the prompt attends over its own
bf16 K/V; a decode step stores one int8 row and attends through
:func:`~aki_torch.ops.decode_attention.decode_attention_flat`. With
``cache_slots`` a prompt's rows go to the given rows of a wider serving
cache. Caches are updated in place.

The projections go through :func:`~aki_torch.models.quant.project`, so the
same layer serves float and quantized (:mod:`aki_torch.models.quant`)
weights; under quantized weights a prefill with ``use_flash`` attends
through :func:`~aki_torch.ops.attention.decoder_attention_bf16p`, as the
JAX package's serving prefill does.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.attention import decoder_attention_bf16p, dense_attention
from ..ops.decode_attention import decode_attention_flat, quantize_kv_flat
from ..ops.flash_mma import flash_mma_attention
from ..ops.masks import MMASpec
from ..ops.rope import apply_rope, rope_cos_sin
from .common import BF16, Policy, empty, remat_call, rmsnorm
from .configs import Phi3Config
from .quant import is_quantized, norm_quant_acts, project, silu_mul_quant_acts


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


@dataclasses.dataclass
class KVCacheQ:
    """Int8 KV cache in the flat layout (counterpart of the JAX package's
    ``KVCacheQ``): ``k``, ``v`` int8 ``(L, B, S, Hkv*D)``, all heads of a
    token in one row; ``ks``, ``vs`` f32 per-(token, head) scales
    ``(L, B, S, Hkv)``, token-major, so that a decode step writes one
    contiguous row of each."""

    k: torch.Tensor
    ks: torch.Tensor
    v: torch.Tensor
    vs: torch.Tensor

    @staticmethod
    def create(cfg: Phi3Config, batch: int, max_len: int, device="cpu") -> "KVCacheQ":
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads * cfg.head_dim)
        sshape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads)
        return KVCacheQ(k=torch.zeros(shape, dtype=torch.int8, device=device),
                        ks=torch.ones(sshape, dtype=torch.float32, device=device),
                        v=torch.zeros(shape, dtype=torch.int8, device=device),
                        vs=torch.ones(sshape, dtype=torch.float32, device=device))

    def buffers(self) -> tuple[torch.Tensor, ...]:
        return self.k, self.ks, self.v, self.vs


def slot_rows(slots, width: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The rows of a slot-scatter prefill: (batch rows, their cache rows),
    dropping the rows whose slot is out of range (the JAX scatter's
    ``mode="drop"``; the server pads an admission with slot ``width``).
    ``slots`` is read on the host."""
    slots = torch.as_tensor(slots).tolist()
    src = [r for r, s in enumerate(slots) if 0 <= s < width]
    as_idx = lambda x: torch.tensor(x, dtype=torch.int64, device=device)  # noqa: E731
    return as_idx(src), as_idx([slots[r] for r in src])


def _write_rows(layer_cache: torch.Tensor, new: torch.Tensor,
                pos: torch.Tensor) -> None:
    """``layer_cache[b, pos[b, t]] = new[b, t]``, dropping positions past the
    cache as the JAX scatter's ``mode="drop"`` does — without a host sync:
    out-of-range rows rewrite the value already at the clamped slot."""
    s = layer_cache.shape[1]
    bidx = torch.arange(new.shape[0], device=new.device)[:, None]
    slot = pos.clamp(max=s - 1)
    keep = (pos < s).reshape(pos.shape + (1,) * (new.dim() - 2))
    layer_cache[bidx, slot] = torch.where(keep, new.to(layer_cache.dtype),
                                          layer_cache[bidx, slot])


def _store_prefill(layer_cache: torch.Tensor, new: torch.Tensor, rows) -> None:
    """Write one layer's prefill block: at rows ``[0, B)`` of the cache, or
    with ``rows`` = (batch rows, cache rows) into those rows of a wider
    serving cache (counterpart of the JAX ``_store_prefill``)."""
    t = new.shape[1]
    if rows is None:
        layer_cache[: new.shape[0], :t] = new
    else:
        src, dst = rows
        layer_cache[dst, :t] = new[src].to(layer_cache.dtype)


@dataclasses.dataclass
class _CacheStep:
    """What a layer needs of the cache in one forward: the cache, the write
    positions (B, T), the slot rows of a serving prefill, the decode's key
    counts (B,) int32 and its live width."""

    cache: KVCache | KVCacheQ
    wpos: torch.Tensor
    rows: tuple[torch.Tensor, torch.Tensor] | None
    lengths: torch.Tensor | None
    live_width: int | None


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
                step: _CacheStep | None, li: int, policy: Policy, use_flash: bool):
        b, t, _ = x.shape
        nh, nkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        eps = cfg.rms_norm_eps
        att, mlp = self.self_attn, self.mlp
        # fused norm + quantize ahead of an int8 product (W8A8 serving), the
        # plain norm otherwise: norm_quant_acts decides from the weight
        h = norm_quant_acts("rms", policy.cast(self.input_layernorm.weight), None, x, eps,
                            probe=att["qkv_proj"])
        qkv = project(att["qkv_proj"], h, policy)
        q = qkv[..., : nh * dh].reshape(b, t, nh, dh)
        k = qkv[..., nh * dh: (nh + nkv) * dh].reshape(b, t, nkv, dh)
        v = qkv[..., (nh + nkv) * dh:].reshape(b, t, nkv, dh).contiguous()
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        attn = None
        k_att, v_att, kv_valid_att = k, v, kv_valid
        cache = None if step is None else step.cache
        if isinstance(cache, KVCacheQ):
            k8, ksc = quantize_kv_flat(k)
            v8, vsc = quantize_kv_flat(v)
            new = (k8, ksc, v8, vsc)
            if t == 1:
                for buf, row in zip(cache.buffers(), new):
                    _write_rows(buf[li], row, step.wpos)
                attn = decode_attention_flat(q, cache.k, cache.ks, cache.v, cache.vs,
                                             step.lengths, li, live_width=step.live_width)
            else:
                # prefill stores the quantized block and attends over its
                # own bf16 K/V: the quantized copy is not read back
                for buf, row in zip(cache.buffers(), new):
                    _store_prefill(buf[li], row, step.rows)
                kv_valid_att = None if kv_valid is None else kv_valid[:, :t]
        elif cache is not None:
            ck, cv = cache.k[li], cache.v[li]
            if t == 1:
                _write_rows(ck, k, step.wpos)
                _write_rows(cv, v, step.wpos)
            else:
                _store_prefill(ck, k, step.rows)
                _store_prefill(cv, v, step.rows)
            if t > 1 and step.rows is not None:
                # slot-scatter prefill: the cache is wider than the batch
                # and only written; attend over the local K/V block
                kv_valid_att = None if kv_valid is None else kv_valid[:, :t]
            else:
                k_att, v_att = ck.to(q.dtype), cv.to(q.dtype)

        if attn is None:
            if use_flash and t > 1 and is_quantized(att["qkv_proj"]):
                attend = decoder_attention_bf16p
            else:
                attend = flash_mma_attention if use_flash else dense_attention
            attn = attend(q, k_att, v_att, spec=spec, kv_valid=kv_valid_att,
                          q_offset=q_offset)
        x = x + project(att["o_proj"], attn.reshape(b, t, nh * dh), policy)

        h2 = norm_quant_acts("rms", policy.cast(self.post_attention_layernorm.weight), None,
                             x, eps, probe=mlp["gate_up_proj"])
        gate, up = project(mlp["gate_up_proj"], h2, policy).chunk(2, dim=-1)
        act = silu_mul_quant_acts(gate, up, probe=mlp["down_proj"])
        return x + project(mlp["down_proj"], act, policy)


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
        cache: KVCache | KVCacheQ | None = None,
        cache_index: torch.Tensor | None = None,
        policy: Policy = BF16,
        use_flash: bool = True,
        remat: bool = False,
        remat_policy: str = "full",
        live_width: int | None = None,
        cache_slots=None,
    ) -> tuple[torch.Tensor, KVCache | KVCacheQ | None]:
        """Run the stack over ``inputs_embeds`` (B, T, D).

        positions: (B, T) absolute RoPE positions. spec: MMA block spec
        (None = causal). kv_valid: key validity — (B, T) without a cache,
        (B, max_len) over the whole cache buffer with one. q_offset:
        absolute position of the first query row. cache / cache_index: KV
        cache and per-row write offsets (B,). live_width: only the first
        ``live_width`` rows of an int8 cache are read in decode (the
        server's tail compaction); other paths ignore it. cache_slots: (B,)
        cache row of each prompt row for a prefill into a wider serving
        cache (a slot of the cache's width drops the row; read on the host).

        Returns (final-normed hidden states (B, T, D), the cache).
        """
        cfg = self.cfg
        x = inputs_embeds.to(policy.compute_dtype)
        cos, sin = rope_cos_sin(cfg.rope, positions)
        step = None
        if cache is not None:
            b, t = x.shape[:2]
            wpos = cache_index.to(torch.int64)[:, None] + torch.arange(t, device=x.device)
            rows = None if cache_slots is None else slot_rows(cache_slots, cache.k.shape[1],
                                                              x.device)
            lengths = None
            if isinstance(cache, KVCacheQ) and t == 1:
                lengths = (torch.as_tensor(q_offset, device=x.device).expand(b)
                           .to(torch.int32) + 1).contiguous()
            step = _CacheStep(cache, wpos, rows, lengths, live_width)
        remat = remat and cache is None
        for li, layer in enumerate(self.layers):
            x = remat_call(remat, remat_policy, layer, x, cos, sin, cfg, spec, kv_valid,
                           q_offset, step, li, policy, use_flash)
        return rmsnorm(policy.cast(self.norm.weight), x, cfg.rms_norm_eps), cache

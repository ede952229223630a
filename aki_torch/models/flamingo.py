"""Flamingo gated cross-attention decoder (counterpart of
``aki_tpu/models/flamingo.py``; the reference's OpenFlamingo path).

- :class:`GatedCrossAttentionBlock`: masked text -> media cross-attention
  and a LayerNorm-first feed-forward (tanh-approximate GELU), each added to
  the text stream through a ``tanh`` gate that starts at 0, so that the
  block is the identity at init. Parameters carry OpenFlamingo's names
  (``attn.norm``, ``attn.to_q``, ``attn.to_kv``, ``attn.to_out``,
  ``attn_gate``, ``ff.0``, ``ff.1``, ``ff.3``, ``ff_gate``).
- Media-location time masking: a text token's time is the number of
  ``<image>`` tokens up to it; with ``only_attend_immediate_media`` it
  attends to the latents of that image only (``==``), otherwise to every
  image so far (``>=``). Masked scores are set to the f32 minimum before the
  softmax, so a row with no allowed image gets a uniform softmax, as in JAX;
  only under immediate masking are the rows before any image zeroed.
- :func:`flamingo_decoder_forward`: block ``g`` runs before decoder layer
  ``g * cross_attn_every_n`` (JAX's grouping), and the decoder layers stay
  causal through :class:`~aki_torch.models.phi3.Phi3DecoderLayer`, so that
  their attention is the flash forward kernel on the card.

The cross-attention's products are plain einsums in f32 over operands in the
compute dtype (JAX's ``preferred_element_type=f32``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.rope import rope_cos_sin
from .common import (BF16, Policy, empty, init_const, init_norm, init_normal, layernorm,
                     linear, remat_call, resolve_device, rmsnorm)
from .configs import AKIConfig
from .phi3 import fused_parts

XATTN_INIT_STD = 0.02


class MaskedCrossAttention(nn.Module):
    def __init__(self, dim: int, dim_visual: int, heads: int, dim_head: int, *, device,
                 dtype):
        super().__init__()
        inner = heads * dim_head
        kw = dict(device=device, dtype=dtype)
        self.norm = empty(nn.LayerNorm, dim, **kw)
        self.to_q = empty(nn.Linear, dim, inner, bias=False, **kw)
        self.to_kv = empty(nn.Linear, dim_visual, 2 * inner, bias=False, **kw)
        self.to_out = empty(nn.Linear, inner, dim, bias=False, **kw)


class GatedCrossAttentionBlock(nn.Module):
    """One gated block, built on ``device`` (``"cuda"`` by default; raises
    without a card unless ``device="cpu"``) with JAX's init (``init_gated_xattn``) drawn from ``generator``: the products
    N(0, 0.02^2), the LayerNorms at identity, both gates 0."""

    def __init__(self, dim: int, dim_visual: int, heads: int = 8, dim_head: int = 64,
                 ff_mult: int = 4, device="cuda", dtype=torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype)
        self.attn = MaskedCrossAttention(dim, dim_visual, heads, dim_head, **kw)
        self.attn_gate = nn.Parameter(torch.empty(1, **kw))
        self.ff = nn.Sequential(empty(nn.LayerNorm, dim, **kw),
                                empty(nn.Linear, dim, dim * ff_mult, bias=False, **kw),
                                nn.GELU(approximate="tanh"),
                                empty(nn.Linear, dim * ff_mult, dim, bias=False, **kw))
        self.ff_gate = nn.Parameter(torch.empty(1, **kw))
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.reset_parameters(generator)

    def reset_parameters(self, gen: torch.Generator) -> None:
        a = self.attn
        init_normal(gen, XATTN_INIT_STD, a.to_q.weight, a.to_kv.weight, a.to_out.weight,
                    self.ff[1].weight, self.ff[3].weight)
        init_norm(a.norm, self.ff[0])
        init_const(0.0, self.attn_gate, self.ff_gate)


def _gate(gate: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``tanh`` of a gate rounded to ``dtype``, taken in f32, as ``dtype``."""
    return torch.tanh(gate.to(dtype).float()).to(dtype)


def gated_xattn_block(
    block: GatedCrossAttentionBlock,
    x: torch.Tensor,                 # (B, T_txt, D) text stream
    media: torch.Tensor,             # (B, T_img, n_lat, D_vis)
    media_locations: torch.Tensor,   # (B, T_txt) bool, True at <image> tokens
    heads: int = 8,
    dim_head: int = 64,
    only_attend_immediate_media: bool = True,
    use_cached_media: bool = False,
) -> torch.Tensor:
    """One gated block over ``x``, its weights cast to x's dtype (the
    compute dtype). With ``use_cached_media`` every text token takes the
    time of the row's last image (a decode step's view)."""
    b, t_txt, _ = x.shape
    t_img, n_lat = media.shape[1], media.shape[2]
    dt = x.dtype
    p = Policy(compute_dtype=dt)
    a = block.attn

    h = layernorm(a.norm.weight.to(dt), a.norm.bias.to(dt), x)
    q = linear(a.to_q, h, p).reshape(b, t_txt, heads, dim_head)
    m = media.reshape(b, t_img * n_lat, -1).to(dt)
    k, v = linear(a.to_kv, m, p).chunk(2, dim=-1)
    k = k.reshape(b, -1, heads, dim_head)
    v = v.reshape(b, -1, heads, dim_head)
    sim = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * dim_head ** -0.5

    locs = media_locations.to(torch.int32)
    if use_cached_media:
        text_time = locs.sum(1, keepdim=True).expand(b, t_txt)
    else:
        text_time = locs.cumsum(1)
    media_time = torch.arange(1, t_img + 1, device=x.device).repeat_interleave(n_lat)
    tt, mt = text_time[:, None, :, None], media_time[None, None, None, :]
    ok = (tt == mt) if only_attend_immediate_media else (tt >= mt)
    sim = torch.where(ok, sim, torch.finfo(torch.float32).min)
    attn = torch.softmax(sim, dim=-1)
    if only_attend_immediate_media:
        # text with no preceding image attends to nothing
        attn = torch.where((text_time == 0)[:, None, :, None], 0.0, attn)

    out = torch.einsum("bhij,bjhd->bihd", attn.to(v.dtype).float(), v.float()).to(dt)
    out = linear(a.to_out, out.reshape(b, t_txt, heads * dim_head), p)
    x = x + out * _gate(block.attn_gate, dt)

    ln, ff1, _, ff2 = block.ff
    f = linear(ff1, layernorm(ln.weight.to(dt), ln.bias.to(dt), x), p)
    f = F.gelu(f.float(), approximate="tanh").to(f.dtype)
    return x + linear(ff2, f, p) * _gate(block.ff_gate, dt)


def flamingo_decoder_forward(
    lang_model,
    xattn_blocks: nn.ModuleList,
    cfg: AKIConfig,
    inputs_embeds: torch.Tensor,
    positions: torch.Tensor,
    media: torch.Tensor,             # (B, T_img, n_lat, D) perceiver outputs
    media_locations: torch.Tensor,   # (B, T_txt) bool, True at <image> tokens
    kv_valid: torch.Tensor | None = None,
    cross_attn_every_n: int = 4,
    policy: Policy = BF16,
    use_flash: bool = True,
    remat: bool = False,
    xattn_heads: int = 8,
    xattn_dim_head: int = 64,
    remat_policy: str = "full",
) -> torch.Tensor:
    """The causal decoder of ``lang_model`` (an AKI model's
    ``lang_model``: its ``model.layers`` and ``model.norm``) with gated
    block ``g`` of ``xattn_blocks`` before layer ``g * cross_attn_every_n``.
    Under ``remat`` each block and each decoder layer is a recomputed region
    (``remat_policy`` as in :data:`~aki_torch.models.common.REMAT_POLICIES`).
    Returns the final-normed hidden states (B, T_txt, D)."""
    decoder = lang_model.model
    pcfg = cfg.phi3
    n = cross_attn_every_n
    if pcfg.num_layers % n or len(xattn_blocks) != pcfg.num_layers // n:
        raise ValueError(f"{pcfg.num_layers} decoder layers need {pcfg.num_layers // n} "
                         f"blocks at cross_attn_every_n={n} (got {len(xattn_blocks)}), "
                         "and num_layers must be divisible by it")
    x = inputs_embeds.to(policy.compute_dtype)
    media = media.to(policy.compute_dtype)
    cos, sin = rope_cos_sin(pcfg.rope, positions)
    parts = fused_parts(pcfg)
    for li, layer in enumerate(decoder.layers):
        if li % n == 0:
            x = remat_call(remat, remat_policy, gated_xattn_block, xattn_blocks[li // n], x,
                           media, media_locations, xattn_heads, xattn_dim_head)
        x, _ = remat_call(remat, remat_policy, layer, x, cos, sin, pcfg, None, kv_valid, 0,
                          None, li, policy, use_flash, parts=parts)
    return rmsnorm(policy.cast(decoder.norm.weight), x, pcfg.rms_norm_eps)

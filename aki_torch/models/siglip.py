"""SigLIP vision transformer, SO400M geometry (counterpart of
``aki_tpu/models/siglip.py:siglip_forward``).

Patch embed as one matmul over patchified NHWC pixels (the 14x14 stride-14
convolution's weight is kept in its checkpoint shape), learned positions,
pre-norm blocks with biased QKV and a gelu-tanh MLP, and a post-LN after
the last block. Attention is full (non-causal) through the flash MMA kernel.
Parameter names follow HF ``SiglipVisionTransformer``, as the reference
checkpoint stores it under ``vision_encoder.``.

Under weights quantized by :func:`~aki_torch.models.quant.quantize_params`
(``vision=True``) the block follows the JAX tower's serving form
(``aki_tpu/models/siglip.py:97-143``): fused layernorm + quantize at both
norms, int8 products with float biases, fused gelu(fc1 + b) + quantize
ahead of fc2 over the padded MLP width, and, on the card, attention with
bf16 probabilities (:func:`~aki_torch.ops.attention.encoder_attention_bf16p`,
which launches the hand-written kernel of
:mod:`~aki_torch.ops.flash_bf16p` on bf16 tensors and runs plain torch on
f32 ones); on the CPU the tower keeps the dense attention, as JAX does off
the TPU.

Under tensor parallelism (``tp``, :mod:`aki_torch.parallel.tensor`) each
rank attends over its heads with the flash forward in plain mode, as
JAX's ``flash_mma_attention_tp`` route does (also with int8 weights,
whose projections stay whole); float weights are cut Megatron-style, the
patch embedding by its output channels, gathered.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dense_attention, encoder_attention_bf16p, on_card
from ..ops.flash_mma import flash_mma_attention
from ..parallel.tensor import column_parallel, row_parallel
from .common import (BF16, Policy, empty, init_const, init_norm, init_normal,
                     layernorm)
from .configs import SigLIPVisionConfig
from .quant import gelu_quant_acts, is_quantized, mm, norm_quant_acts, project


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, nh*nw, patch*patch*C), row-major patches in
    (ph, pw, c) order. Trailing pixels that do not fill a patch are dropped
    (SigLIP-384/patch14 uses 27x14 = 378 of 384 px)."""
    b, h, w, c = images.shape
    nh, nw = h // patch, w // patch
    x = images[:, : nh * patch, : nw * patch]
    x = x.reshape(b, nh, patch, nw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, nh * nw, patch * patch * c)


class SiglipEncoderLayer(nn.Module):
    def __init__(self, cfg: SigLIPVisionConfig, *, device, dtype):
        super().__init__()
        d, inter = cfg.hidden_size, cfg.intermediate_size
        lin = lambda i, o: empty(nn.Linear, i, o, device=device, dtype=dtype)  # noqa: E731
        self.layer_norm1 = empty(nn.LayerNorm, d, device=device, dtype=dtype)
        self.self_attn = nn.ModuleDict({
            "q_proj": lin(d, d), "k_proj": lin(d, d), "v_proj": lin(d, d),
            "out_proj": lin(d, d),
        })
        self.layer_norm2 = empty(nn.LayerNorm, d, device=device, dtype=dtype)
        self.mlp = nn.ModuleDict({"fc1": lin(d, inter), "fc2": lin(inter, d)})

    def forward(self, x, cfg: SigLIPVisionConfig, policy: Policy, use_flash: bool, tp=None):
        """``tp``: the tower's :class:`~aki_torch.parallel.tensor.TensorParallel`
        (float weights hold the rank's heads and fc1 columns; quantized ones
        are whole and the rank attends over its heads of q, k, v)."""
        b, t, d = x.shape
        nh, dh, eps = cfg.num_heads, cfg.head_dim, cfg.layer_norm_eps
        cast = policy.cast
        att, mlp = self.self_attn, self.mlp
        ln1, ln2 = self.layer_norm1, self.layer_norm2
        fused_qkv = "qkv_proj" in att                  # quantize_params(fuse=True)
        probe = att["qkv_proj" if fused_qkv else "q_proj"]
        quant = is_quantized(probe)
        if tp is not None and not quant:                # Megatron: local heads
            nh //= tp.size
        h = norm_quant_acts("ln", cast(ln1.weight), cast(ln1.bias), x, eps, probe=probe)
        if fused_qkv:
            q, k, v = (y.reshape(b, t, nh, dh)
                       for y in project(att["qkv_proj"], h, policy).split(d, dim=-1))
        else:
            q, k, v = (column_parallel(att[n], h, policy, tp).reshape(b, t, nh, dh)
                       for n in ("q_proj", "k_proj", "v_proj"))
        if tp is not None and quant:
            q, k, v = (tp.heads(y).contiguous() for y in (q, k, v))
        # JAX's tower: the flash forward on the rank's heads under tp (that
        # branch comes first), bf16-P attention when serving int8 weights
        if use_flash and quant and tp is None and on_card(x):
            o = encoder_attention_bf16p(q, k, v)
        else:
            o = (flash_mma_attention if use_flash else dense_attention)(q, k, v, causal=False)
        o = o.reshape(b, t, o.shape[-2] * dh)
        if tp is not None and quant:
            o = tp.gather_last(o)                       # for the whole out_proj
        x = x + row_parallel(att["out_proj"], o, policy, tp)
        h2 = norm_quant_acts("ln", cast(ln2.weight), cast(ln2.bias), x, eps, probe=mlp["fc1"])
        if is_quantized(mlp["fc1"]):
            # the fc1 bias goes into the fused gelu + quantize, as in JAX
            y1 = gelu_quant_acts(mm(h2, mlp["fc1"]), cast(mlp["fc1"].bias), probe=mlp["fc2"])
            return x + project(mlp["fc2"], y1, policy)
        y1 = column_parallel(mlp["fc1"], h2, policy, tp)
        y1 = F.gelu(y1.float(), approximate="tanh").to(y1.dtype)
        return x + row_parallel(mlp["fc2"], y1, policy, tp)


class SigLIPVisionTransformer(nn.Module):
    """Pixels ``(B, H, W, C)`` (bicubic 384, (x-0.5)/0.5) -> last hidden
    state ``(B, num_patches, hidden)`` in the compute dtype."""

    def __init__(self, cfg: SigLIPVisionConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        d, p, c = cfg.hidden_size, cfg.patch_size, cfg.num_channels
        self.embeddings = nn.ModuleDict({
            "patch_embedding": empty(nn.Conv2d, c, d, kernel_size=p, stride=p,
                                     device=device, dtype=dtype),
            "position_embedding": empty(nn.Embedding, cfg.num_patches, d,
                                        device=device, dtype=dtype),
        })
        self.encoder = nn.ModuleDict({"layers": nn.ModuleList(
            SiglipEncoderLayer(cfg, device=device, dtype=dtype)
            for _ in range(cfg.num_layers))})
        self.post_layernorm = empty(nn.LayerNorm, d, device=device, dtype=dtype)
        # set by aki_torch.parallel.tensor.shard_tensor_parallel
        self.tp = None

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The JAX init: N(0, 0.02) weights, zero biases, identity norms."""
        emb = self.embeddings
        init_normal(gen, 0.02, emb["patch_embedding"].weight,
                    emb["position_embedding"].weight)
        init_const(0.0, emb["patch_embedding"].bias)
        for layer in self.encoder["layers"]:
            for lin in (*layer.self_attn.values(), *layer.mlp.values()):
                init_normal(gen, 0.02, lin.weight)
                init_const(0.0, lin.bias)
            init_norm(layer.layer_norm1, layer.layer_norm2)
        init_norm(self.post_layernorm)

    def forward(self, images: torch.Tensor, policy: Policy = BF16,
                use_flash: bool = True) -> torch.Tensor:
        cfg, cast, tp = self.cfg, policy.cast, self.tp
        conv = self.embeddings["patch_embedding"]
        # conv weight (out, c, kh, kw) -> patchify order (kh*kw*c, out); under
        # tp the rank's output channels, gathered
        w = cast(conv.weight).permute(2, 3, 1, 0).reshape(-1, conv.weight.shape[0])
        x = patchify(images.to(policy.compute_dtype), cfg.patch_size) @ w + cast(conv.bias)
        if tp is not None:
            x = tp.gather_last(x)
        x = x + cast(self.embeddings["position_embedding"].weight)
        for layer in self.encoder["layers"]:
            x = layer(x, cfg, policy, use_flash, tp)
        return layernorm(cast(self.post_layernorm.weight),
                         cast(self.post_layernorm.bias), x, cfg.layer_norm_eps)

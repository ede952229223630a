"""SigLIP vision transformer, SO400M geometry (counterpart of
``aki_tpu/models/siglip.py:siglip_forward``).

Patch embed as one matmul over patchified NHWC pixels (the 14x14 stride-14
convolution's weight is kept in its checkpoint shape), learned positions,
pre-norm blocks with biased QKV and a gelu-tanh MLP, and a post-LN after
the last block. Attention is full (non-causal) through the flash MMA kernel.
Parameter names follow HF ``SiglipVisionTransformer``, as the reference
checkpoint stores it under ``vision_encoder.``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dense_attention
from ..ops.flash_mma import flash_mma_attention
from .common import (BF16, Policy, empty, init_const, init_norm, init_normal,
                     layernorm, linear)
from .configs import SigLIPVisionConfig


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

    def forward(self, x, cfg: SigLIPVisionConfig, policy: Policy, use_flash: bool):
        b, t, d = x.shape
        nh, dh, eps = cfg.num_heads, cfg.head_dim, cfg.layer_norm_eps
        cast = policy.cast
        h = layernorm(cast(self.layer_norm1.weight), cast(self.layer_norm1.bias), x, eps)
        att = self.self_attn
        q, k, v = (linear(att[n], h, policy).reshape(b, t, nh, dh)
                   for n in ("q_proj", "k_proj", "v_proj"))
        attend = flash_mma_attention if use_flash else dense_attention
        o = attend(q, k, v, causal=False)
        x = x + linear(att["out_proj"], o.reshape(b, t, d), policy)
        h2 = layernorm(cast(self.layer_norm2.weight), cast(self.layer_norm2.bias), x, eps)
        y1 = linear(self.mlp["fc1"], h2, policy)
        y1 = F.gelu(y1.float(), approximate="tanh").to(y1.dtype)
        return x + linear(self.mlp["fc2"], y1, policy)


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
        cfg, cast = self.cfg, policy.cast
        conv = self.embeddings["patch_embedding"]
        # conv weight (out, c, kh, kw) -> patchify order (kh*kw*c, out)
        w = cast(conv.weight).permute(2, 3, 1, 0).reshape(-1, cfg.hidden_size)
        x = patchify(images.to(policy.compute_dtype), cfg.patch_size) @ w + cast(conv.bias)
        x = x + cast(self.embeddings["position_embedding"].weight)
        for layer in self.encoder["layers"]:
            x = layer(x, cfg, policy, use_flash)
        return layernorm(cast(self.post_layernorm.weight),
                         cast(self.post_layernorm.bias), x, cfg.layer_norm_eps)

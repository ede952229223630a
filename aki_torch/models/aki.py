"""The AKI model: SigLIP -> Perceiver -> splice -> Phi-3 under MMA attention
(counterpart of ``aki_tpu/models/aki.py``).

:class:`AKIModel` holds the weights under the reference checkpoint's names
(``vision_encoder.*``, ``vision_tokenizer.*``, ``lang_model.*``), so its
``state_dict`` is the reference layout; the functions below are the JAX
module's pipeline pieces.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .common import (BF16, Policy, init_const, init_norm, init_normal,
                     resolve_device)
from .configs import AKIConfig
from .embeddings import (DecoupledEmbedding, DecoupledLinear, decoupled_logits,
                         decoupled_lookup)
from .fusion import SplicedBatch, splice_vision_tokens
from .perceiver import PerceiverResampler
from .phi3 import Phi3Model
from .siglip import SigLIPVisionTransformer


class Phi3ForCausalLM(nn.Module):
    """``lang_model``: the decoder (``model``) and the decoupled head."""

    def __init__(self, cfg: AKIConfig, *, device, dtype):
        super().__init__()
        p = cfg.phi3
        kw = dict(device=device, dtype=dtype)
        embed = DecoupledEmbedding(p.vocab_size, cfg.num_extra_tokens, p.hidden_size, **kw)
        self.model = Phi3Model(p, embed, **kw)
        self.lm_head = DecoupledLinear(p.hidden_size, p.vocab_size,
                                       cfg.num_extra_tokens, **kw)


class AKIModel(nn.Module):
    """The whole model, built on ``device`` (``"cuda"`` by default; raises
    without a card unless ``device="cpu"``) in parameter dtype ``dtype``,
    with random weights at the JAX init scales drawn from ``generator``
    (a fresh one seeded 0 on ``device`` when None)."""

    def __init__(self, cfg: AKIConfig, device="cuda", dtype=torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.vision_encoder = SigLIPVisionTransformer(cfg.siglip, **kw)
        self.vision_tokenizer = PerceiverResampler(cfg.perceiver, **kw)
        self.lang_model = Phi3ForCausalLM(cfg, **kw)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.reset_parameters(generator)

    def reset_parameters(self, gen: torch.Generator) -> None:
        std = self.cfg.phi3.initializer_range
        self.vision_encoder.reset_parameters(gen)
        self.vision_tokenizer.reset_parameters(gen)
        lm = self.lang_model
        init_normal(gen, std, lm.model.embed_tokens.weight,
                    lm.model.embed_tokens.additional_embedding.weight,
                    lm.lm_head.weight, lm.lm_head.additional_fc.weight)
        init_const(0.0, lm.lm_head.bias, lm.lm_head.additional_fc.bias)
        for layer in lm.model.layers:
            init_normal(gen, std, *(m.weight for m in (*layer.self_attn.values(),
                                                       *layer.mlp.values())))
            init_norm(layer.input_layernorm, layer.post_attention_layernorm)
        init_norm(lm.model.norm)

    @property
    def device(self) -> torch.device:
        return self.lang_model.lm_head.bias.device


@dataclasses.dataclass
class AKIOutput:
    logits: torch.Tensor          # (B, T_full, output_vocab) over the spliced sequence
    loss: torch.Tensor | None     # mean shifted CE over non-ignored labels
    spliced: SplicedBatch


def encode_vision(model: AKIModel, images: torch.Tensor, policy: Policy = BF16,
                  use_flash: bool = True, remat: bool = False,
                  remat_policy: str = "full") -> torch.Tensor:
    """Pixels (B, H, W, C) -> vision tokens (B, n_vis, D_lm). The frozen
    tower runs without gradients (the counterpart of ``stop_gradient``); the
    perceiver stays differentiable, recomputed per block under ``remat``."""
    with torch.no_grad():
        feats = model.vision_encoder(images, policy, use_flash)
    return model.vision_tokenizer(feats, policy, remat, remat_policy)


def embed_text(model: AKIModel, ids: torch.Tensor, policy: Policy = BF16) -> torch.Tensor:
    emb = model.lang_model.model.embed_tokens
    return decoupled_lookup(policy.cast(emb.weight),
                            policy.cast(emb.additional_embedding.weight),
                            ids, model.cfg.initial_tokenizer_len)


def lm_logits(model: AKIModel, hidden: torch.Tensor, policy: Policy = BF16) -> torch.Tensor:
    """Logits of ``hidden`` through the decoupled head; a head quantized by
    :func:`~aki_torch.models.quant.quantize_params` (``lm_head.quant``)
    goes through :func:`~aki_torch.models.quant.mm`, its bias and the extra
    head stay float."""
    head = model.lang_model.lm_head
    quant = getattr(head, "quant", None)
    return decoupled_logits(hidden, policy.cast(head.weight) if quant is None else quant,
                            policy.cast(head.additional_fc.weight),
                            model.cfg.initial_tokenizer_len,
                            head_b=head.bias, extra_b=head.additional_fc.bias)


def next_token_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean shifted cross-entropy over labels != -100, in f32."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:]
    valid = shift_labels != -100
    safe = torch.where(valid, shift_labels, 0).clamp(0, shift_logits.shape[-1] - 1)
    logp = torch.log_softmax(shift_logits, dim=-1)
    tok = torch.gather(logp, -1, safe[..., None].to(torch.int64))[..., 0]
    total = torch.where(valid, -tok, 0.0).sum()
    return total / valid.sum().clamp(min=1)


def aki_forward(
    model: AKIModel,
    input_ids,
    images,
    attn_valid,
    labels=None,
    policy: Policy = BF16,
    use_flash: bool = True,
    order: str = "image_first",
    vision_tokens: torch.Tensor | None = None,
    device="cuda",
    remat: bool = False,
    remat_policy: str = "full",
) -> AKIOutput:
    """Training/eval forward over the whole spliced sequence.

    input_ids (B, T_txt) with one ``<image>`` per row; images (B, H, W, C)
    (or None with ``vision_tokens``); attn_valid (B, T_txt) right-padded 0/1;
    labels optional (B, T_txt) with -100 on prompt/pad; order
    ``"image_first"`` (MMA) or ``"text_first"`` (DOT ablation); remat
    recomputes each Perceiver block and decoder layer in the backward
    (``remat_policy`` as in :data:`~aki_torch.models.common.REMAT_POLICIES`).
    """
    device = resolve_device(device)
    to = lambda x: None if x is None else torch.as_tensor(x, device=device)  # noqa: E731
    input_ids, attn_valid, labels = to(input_ids), to(attn_valid), to(labels)
    cfg = model.cfg
    if vision_tokens is None:
        vision_tokens = encode_vision(model, to(images), policy, use_flash, remat,
                                      remat_policy)
    sp = splice_vision_tokens(embed_text(model, input_ids, policy), vision_tokens,
                              input_ids, attn_valid, cfg.media_token_id,
                              cfg.assistant_token_id, labels=labels, order=order)
    hidden, _ = model.lang_model.model(sp.embeds, sp.positions, spec=sp.spec,
                                       kv_valid=sp.attn_valid, policy=policy,
                                       use_flash=use_flash, remat=remat,
                                       remat_policy=remat_policy)
    logits = lm_logits(model, hidden, policy)
    loss = next_token_loss(logits, sp.labels) if labels is not None else None
    return AKIOutput(logits=logits, loss=loss, spliced=sp)

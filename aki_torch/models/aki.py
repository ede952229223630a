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

from ..parallel.tensor import column_product
from .common import (BF16, Policy, init_const, init_norm, init_normal,
                     resolve_device)
from .configs import AKIConfig
from .embeddings import (DecoupledEmbedding, DecoupledLinear, decoupled_logits,
                         decoupled_lookup)
from .fusion import SplicedBatch, splice_vision_tokens, splice_vision_tokens_multi
from .moe import MoEMLP
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
            init_normal(gen, std, *(m.weight for m in layer.self_attn.values()))
            if isinstance(layer.mlp, MoEMLP):
                layer.mlp.reset_parameters(gen, std)
            else:
                init_normal(gen, std, *(m.weight for m in layer.mlp.values()))
            init_norm(layer.input_layernorm, layer.post_attention_layernorm)
        init_norm(lm.model.norm)

    @property
    def device(self) -> torch.device:
        return self.lang_model.lm_head.bias.device

    def forward(self, *args, **kwargs) -> "AKIOutput":
        """:func:`aki_forward` on this model. The training forward goes
        through the module call, so that a model sharded with FSDP2
        gathers its root parameters (the embeddings, the head, the final
        norm) around it."""
        return _aki_forward(self, *args, **kwargs)


@dataclasses.dataclass
class AKIOutput:
    logits: torch.Tensor          # (B, T_full, output_vocab) over the spliced sequence
    loss: torch.Tensor | None     # mean shifted CE over non-ignored labels
    spliced: SplicedBatch
    aux: torch.Tensor | None = None   # the MoE decoder's Switch aux loss (f32)


def encode_vision(model: AKIModel, images: torch.Tensor, policy: Policy = BF16,
                  use_flash: bool = True, remat: bool = False,
                  remat_policy: str = "full") -> torch.Tensor:
    """Pixels (B, H, W, C) -> vision tokens (B, n_vis, D_lm), or
    (B, N_img, H, W, C) -> (B, N_img, n_vis, D_lm) for interleaved rows (the
    tower and the perceiver run once over the B * N_img images). The frozen
    tower runs without gradients (the counterpart of ``stop_gradient``); the
    perceiver stays differentiable, recomputed per block under ``remat``."""
    lead = images.shape[:-3]
    images = images.reshape(-1, *images.shape[-3:])
    with torch.no_grad():
        feats = model.vision_encoder(images, policy, use_flash)
    toks = model.vision_tokenizer(feats, policy, remat, remat_policy)
    return toks.reshape(*lead, *toks.shape[1:])


def embed_text(model: AKIModel, ids: torch.Tensor, policy: Policy = BF16) -> torch.Tensor:
    emb = model.lang_model.model.embed_tokens
    return decoupled_lookup(policy.cast(emb.weight),
                            policy.cast(emb.additional_embedding.weight),
                            ids, model.cfg.initial_tokenizer_len)


def lm_logits(model: AKIModel, hidden: torch.Tensor, policy: Policy = BF16) -> torch.Tensor:
    """Logits of ``hidden`` through the decoupled head; a head quantized by
    :func:`~aki_torch.models.quant.quantize_params` (``lm_head.quant``)
    goes through :func:`~aki_torch.models.quant.mm`, its bias and the extra
    head stay float. Under tensor parallelism (``lm_head.tp``) every rank
    returns the whole logits, gathered along the vocab."""
    head = model.lang_model.lm_head
    quant = getattr(head, "quant", None)
    tp = getattr(head, "tp", None)
    if tp is not None:
        # vocab-parallel head: each rank's rows of the vocab (and of the
        # bias), a column-parallel product, gathered; the gather's backward
        # keeps the rank's slice. The extra head is whole on every rank
        local = column_product(hidden, policy.cast(head.weight).t(), tp)
        local = local + head.bias.to(local.dtype)
        base = tp.gather_last(local)[..., :model.cfg.initial_tokenizer_len]
        extra = hidden @ policy.cast(head.additional_fc.weight).T
        extra = extra + head.additional_fc.bias.to(extra.dtype)
        return torch.cat([base, extra], dim=-1)
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


def shift_labels(labels: torch.Tensor) -> torch.Tensor:
    """Row t's target, ``labels[:, t + 1]``, and -100 at the last row: the
    label shift done once on the whole spliced sequence, before a split
    along T (a shard's last row needs the next shard's first label)."""
    pad = torch.full_like(labels[:, :1], -100)
    return torch.cat([labels[:, 1:], pad], dim=1)


def shard_token_loss(logits: torch.Tensor, targets: torch.Tensor, group) -> torch.Tensor:
    """This rank's share of the global mean cross-entropy: the sum over its
    rows of the shifted ``targets`` (-100 ignored) over the count of valid
    targets summed over ``group`` (the batch and sequence ranks). The
    shares of the group's ranks add up to JAX's ``next_token_loss`` of the
    global batch, also when ranks hold different numbers of labels."""
    import torch.distributed as dist

    logits = logits.float()
    valid = targets != -100
    safe = torch.where(valid, targets, 0).clamp(0, logits.shape[-1] - 1)
    logp = torch.log_softmax(logits, dim=-1)
    tok = torch.gather(logp, -1, safe[..., None].to(torch.int64))[..., 0]
    total = torch.where(valid, -tok, 0.0).sum()
    count = valid.sum().to(torch.float32)
    dist.all_reduce(count, group=group)
    return total / count.clamp(min=1)


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
    loss_group=None,
    seq_group=None,
) -> AKIOutput:
    """Training/eval forward over the whole spliced sequence.

    input_ids (B, T_txt) with one ``<image>`` per row; images (B, H, W, C)
    (or None with ``vision_tokens``), or (B, N_img, H, W, C) for interleaved
    rows (the j-th ``<image>`` of a row takes its j-th image, through
    :func:`~aki_torch.models.fusion.splice_vision_tokens_multi`; ``order``
    does not apply); attn_valid (B, T_txt) right-padded 0/1;
    labels optional (B, T_txt) with -100 on prompt/pad; order
    ``"image_first"`` (MMA) or ``"text_first"`` (DOT ablation); remat
    recomputes each Perceiver block and decoder layer in the backward
    (``remat_policy`` as in :data:`~aki_torch.models.common.REMAT_POLICIES`).
    A MoE decoder (``cfg.phi3.moe``) returns its Switch aux loss in ``aux``,
    for the trainer to weigh in.

    Sharded (:mod:`aki_torch.parallel`): with ``loss_group`` (the process
    group of the batch and sequence ranks) ``loss`` is this rank's share of
    the global loss (:func:`shard_token_loss`). Under tensor parallelism
    the loss is computed on the logits gathered along the vocab, so every
    rank of the ``tensor`` axis holds the same loss (and its ``tensor``
    ranks are not in ``loss_group``); with ``seq_group`` the
    splice and the label shift run on the whole sequence, then the decoder,
    the head and the loss on this rank's T/n rows (``logits`` holds those).
    """
    return model(input_ids, images, attn_valid, labels=labels, policy=policy,
                 use_flash=use_flash, order=order, vision_tokens=vision_tokens,
                 device=device, remat=remat, remat_policy=remat_policy,
                 loss_group=loss_group, seq_group=seq_group)


def _aki_forward(model, input_ids, images, attn_valid, labels=None, policy=BF16,
                 use_flash=True, order="image_first", vision_tokens=None, device="cuda",
                 remat=False, remat_policy="full", loss_group=None,
                 seq_group=None) -> AKIOutput:
    device = resolve_device(device)
    if seq_group is not None and loss_group is None:
        loss_group = seq_group
    to = lambda x: None if x is None else torch.as_tensor(x, device=device)  # noqa: E731
    input_ids, attn_valid, labels = to(input_ids), to(attn_valid), to(labels)
    cfg = model.cfg
    if vision_tokens is None:
        vision_tokens = encode_vision(model, to(images), policy, use_flash, remat,
                                      remat_policy)
    text_embeds = embed_text(model, input_ids, policy)
    if vision_tokens.dim() == 4:
        sp = splice_vision_tokens_multi(text_embeds, vision_tokens, input_ids, attn_valid,
                                        cfg.media_token_id, cfg.assistant_token_id,
                                        labels=labels)
    else:
        sp = splice_vision_tokens(text_embeds, vision_tokens, input_ids, attn_valid,
                                  cfg.media_token_id, cfg.assistant_token_id, labels=labels,
                                  order=order)
    moe = cfg.phi3.moe is not None
    embeds, positions = sp.embeds, sp.positions
    targets = None if labels is None or loss_group is None else shift_labels(sp.labels)
    seq = None
    if seq_group is not None:
        from ..ops.ring_attention import SeqShard

        seq = SeqShard.create(seq_group, embeds.shape[1], sp.spec, sp.attn_valid)
        rows = slice(seq.lo, seq.lo + seq.tl)
        embeds, positions = embeds[:, rows], positions[:, rows]
        targets = None if targets is None else targets[:, rows]
    hidden, _, *aux = model.lang_model.model(embeds, positions, spec=sp.spec,
                                             kv_valid=sp.attn_valid, policy=policy,
                                             use_flash=use_flash, remat=remat,
                                             remat_policy=remat_policy, with_aux=moe,
                                             seq=seq)
    logits = lm_logits(model, hidden, policy)
    if labels is None:
        loss = None
    elif loss_group is not None:
        loss = shard_token_loss(logits, targets, loss_group)
    else:
        loss = next_token_loss(logits, sp.labels)
    return AKIOutput(logits=logits, loss=loss, spliced=sp, aux=aux[0] if moe else None)

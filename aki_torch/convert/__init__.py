"""JAX parameter tree -> the port's ``state_dict`` (counterpart of
``aki_tpu/convert/jax_to_torch.py``, which the port does not import).

:func:`from_jax_params` takes the JAX package's tree as nested dicts of
numpy arrays — stacked ``(L, ...)`` layers, ``(in, out)`` kernels — and
returns reference-named tensors: layers split, kernels transposed to
``(out, in)``, q/k/v and gate/up fused, the patch-embed matmul folded back
into its convolution shape. Unlike the JAX export it carries the SigLIP
tower (``vision_encoder.*``). A MoE decoder's layers (``phi3/layers/moe``)
become ``mlp.router.weight`` and the stacked experts ``mlp.w_gate``,
``mlp.w_up``, ``mlp.w_down``. :func:`from_jax_xattn` converts the Flamingo
decoder's gated cross-attention blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.configs import AKIConfig


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _lin(x) -> torch.Tensor:
    """(in, out) kernel -> (out, in) weight."""
    return _t(np.asarray(x, dtype=np.float32).T)


def _ln(sd: dict, name: str, p: dict, i=None) -> None:
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    sd[name + ".weight"] = _t(pick(p["scale"]))
    if "bias" in p:
        sd[name + ".bias"] = _t(pick(p["bias"]))


def _moe(sd: dict, pre: str, moe: dict, i: int) -> None:
    """Layer ``i`` of a MoE tree (``router/w`` (L, D, E), the experts
    (L, E, in, out)): the router transposed, the experts as they are."""
    sd[pre + "router.weight"] = _lin(moe["router"]["w"][i])
    for w in ("w_gate", "w_up", "w_down"):
        sd[pre + w] = _t(moe[w][i])


def _phi3(sd: dict, params: dict, cfg: AKIConfig) -> None:
    ph = params["phi3"]
    lay = ph["layers"]
    pre = "lang_model.model."
    sd[pre + "embed_tokens.weight"] = _t(ph["embed"]["table"])
    sd[pre + "embed_tokens.additional_embedding.weight"] = _t(params["extra_embed"]["table"])
    for i in range(cfg.phi3.num_layers):
        p = f"{pre}layers.{i}."
        _ln(sd, p + "input_layernorm", lay["ln1"], i)
        sd[p + "self_attn.qkv_proj.weight"] = torch.cat(
            [_lin(lay[w][i]) for w in ("wq", "wk", "wv")], dim=0)
        sd[p + "self_attn.o_proj.weight"] = _lin(lay["wo"][i])
        _ln(sd, p + "post_attention_layernorm", lay["ln2"], i)
        if "moe" in lay:
            _moe(sd, p + "mlp.", lay["moe"], i)
            continue
        sd[p + "mlp.gate_up_proj.weight"] = torch.cat(
            [_lin(lay[w][i]) for w in ("w_gate", "w_up")], dim=0)
        sd[p + "mlp.down_proj.weight"] = _lin(lay["w_down"][i])
    _ln(sd, pre + "norm", ph["final_norm"])

    head, extra = params["lm_head"], params["extra_head"]
    sd["lang_model.lm_head.weight"] = _lin(head["w"])
    sd["lang_model.lm_head.bias"] = (_t(head["b"]) if "b" in head
                                     else torch.zeros(cfg.phi3.vocab_size))
    sd["lang_model.lm_head.additional_fc.weight"] = _lin(extra["w"])
    sd["lang_model.lm_head.additional_fc.bias"] = (_t(extra["b"]) if "b" in extra
                                                   else torch.zeros(cfg.num_extra_tokens))


def _perceiver(sd: dict, params: dict, cfg: AKIConfig) -> None:
    pc = params["perceiver"]
    lay = pc["layers"]
    pre = "vision_tokenizer."
    sd[pre + "latents"] = _t(pc["latents"])
    for i in range(cfg.perceiver.depth):
        a, f = f"{pre}layers.{i}.0.", f"{pre}layers.{i}.1."
        _ln(sd, a + "norm_media", lay["norm_media"], i)
        _ln(sd, a + "norm_latents", lay["norm_latents"], i)
        for w in ("to_q", "to_kv", "to_out"):
            sd[a + w + ".weight"] = _lin(lay[w][i])
        _ln(sd, f + "0", lay["ff_ln"], i)
        sd[f + "1.weight"] = _lin(lay["ff1"][i])
        sd[f + "3.weight"] = _lin(lay["ff2"][i])
    _ln(sd, pre + "norm", pc["norm"])
    sd[pre + "projection.weight"] = _lin(pc["proj"]["w"])
    sd[pre + "projection.bias"] = _t(pc["proj"]["b"])


def _siglip(sd: dict, params: dict, cfg: AKIConfig) -> None:
    sg = params["siglip"]
    lay = sg["layers"]
    c = cfg.siglip
    pre = "vision_encoder."
    # patchify-matmul kernel (kh*kw*c, out) -> conv weight (out, c, kh, kw)
    w = np.asarray(sg["patch_embed"]["w"], np.float32)
    w = w.reshape(c.patch_size, c.patch_size, c.num_channels, c.hidden_size)
    sd[pre + "embeddings.patch_embedding.weight"] = _t(w.transpose(3, 2, 0, 1))
    sd[pre + "embeddings.patch_embedding.bias"] = _t(sg["patch_embed"]["b"])
    sd[pre + "embeddings.position_embedding.weight"] = _t(sg["pos_embed"])
    for i in range(c.num_layers):
        p = f"{pre}encoder.layers.{i}."
        _ln(sd, p + "layer_norm1", lay["ln1"], i)
        for name, w_, b_ in (("q_proj", "wq", "bq"), ("k_proj", "wk", "bk"),
                             ("v_proj", "wv", "bv"), ("out_proj", "wo", "bo")):
            sd[p + f"self_attn.{name}.weight"] = _lin(lay[w_][i])
            sd[p + f"self_attn.{name}.bias"] = _t(lay[b_][i])
        _ln(sd, p + "layer_norm2", lay["ln2"], i)
        for fc in ("fc1", "fc2"):
            sd[p + f"mlp.{fc}.weight"] = _lin(lay[fc]["w"][i])
            sd[p + f"mlp.{fc}.bias"] = _t(lay[fc]["b"][i])
    _ln(sd, pre + "post_layernorm", sg["post_ln"])


def from_jax_params(params: dict, cfg: AKIConfig) -> dict[str, torch.Tensor]:
    """The JAX package's parameter tree (numpy leaves) as the port's
    float32 ``state_dict``; load it with ``AKIModel.load_state_dict``."""
    sd: dict[str, torch.Tensor] = {}
    _siglip(sd, params, cfg)
    _perceiver(sd, params, cfg)
    _phi3(sd, params, cfg)
    return sd


def from_jax_xattn(xattn: dict) -> dict[str, torch.Tensor]:
    """The JAX Flamingo tree ``xattn`` (``init_gated_xattn``: stacked
    ``(G, ...)`` leaves, ``(in, out)`` kernels) as the ``state_dict`` of an
    ``nn.ModuleList`` of :class:`~aki_torch.models.flamingo.GatedCrossAttentionBlock`,
    OpenFlamingo's names."""
    sd: dict[str, torch.Tensor] = {}
    for g in range(np.asarray(xattn["to_q"]).shape[0]):
        p = f"{g}."
        _ln(sd, p + "attn.norm", xattn["norm"], g)
        for w in ("to_q", "to_kv", "to_out"):
            sd[p + f"attn.{w}.weight"] = _lin(xattn[w][g])
        sd[p + "attn_gate"] = _t(xattn["attn_gate"][g])
        _ln(sd, p + "ff.0", xattn["ff_ln"], g)
        sd[p + "ff.1.weight"] = _lin(xattn["ff1"][g])
        sd[p + "ff.3.weight"] = _lin(xattn["ff2"][g])
        sd[p + "ff_gate"] = _t(xattn["ff_gate"][g])
    return sd

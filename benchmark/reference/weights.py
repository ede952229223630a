"""The weights both sides get: every parameter of AKI under the reference
checkpoint's names, made from the seed on the device.

The random leaves are views of one flat buffer of standard normal draws,
filled in chunks of ``CHUNK`` values, chunk ``c`` from a generator seeded by
``(seed, c)``, then scaled by the leaf's init scale (the JAX package's:
N(0, 0.02) for weights and embeddings, N(0, 1) for the Perceiver's
latents); biases are zero and norm scales one. So a chunk can be made again
alone (:func:`normal_chunk`), and a run can read its start state leaf by
leaf after the program has moved it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

CHUNK = 1 << 28


def sub_seed(*parts: int) -> int:
    """A 63-bit seed for the stream named by ``parts`` (the run's seed
    first), so that every stream of a run is independent of the others."""
    words = np.random.SeedSequence([int(p) for p in parts]).generate_state(2, np.uint32)
    return (int(words[0]) << 31 | int(words[1])) & ((1 << 63) - 1)


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: tuple[int, ...]
    init: str            # "normal" | "zeros" | "ones"
    std: float = 0.0
    offset: int = 0      # first value in the flat normal buffer

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape))


def leaves(cfg: dict) -> list[Leaf]:
    """Every parameter of the model ``cfg`` (the configuration file's
    ``model`` block) in a fixed order, with its shape and init."""
    s, p, d = cfg["siglip"], cfg["perceiver"], cfg["phi3"]
    out: list[tuple] = []

    def lin(prefix, o, i, bias=True, std=0.02):
        out.append((f"{prefix}.weight", (o, i), "normal", std))
        if bias:
            out.append((f"{prefix}.bias", (o,), "zeros", 0.0))

    def norm(prefix, width, bias=True):
        out.append((f"{prefix}.weight", (width,), "ones", 0.0))
        if bias:
            out.append((f"{prefix}.bias", (width,), "zeros", 0.0))

    hs, ps = s["hidden_size"], s["patch_size"]
    n_patch = (s["image_size"] // ps) ** 2
    out.append(("vision_encoder.embeddings.patch_embedding.weight",
                (hs, s["num_channels"], ps, ps), "normal", 0.02))
    out.append(("vision_encoder.embeddings.patch_embedding.bias", (hs,), "zeros", 0.0))
    out.append(("vision_encoder.embeddings.position_embedding.weight", (n_patch, hs),
                "normal", 0.02))
    for i in range(s["num_layers"]):
        pre = f"vision_encoder.encoder.layers.{i}"
        norm(f"{pre}.layer_norm1", hs)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(f"{pre}.self_attn.{n}", hs, hs)
        norm(f"{pre}.layer_norm2", hs)
        lin(f"{pre}.mlp.fc1", s["intermediate_size"], hs)
        lin(f"{pre}.mlp.fc2", hs, s["intermediate_size"])
    norm("vision_encoder.post_layernorm", hs)

    pd, inner = p["dim"], p["dim_head"] * p["heads"]
    out.append(("vision_tokenizer.latents", (p["num_latents"], pd), "normal", 1.0))
    for i in range(p["depth"]):
        pre = f"vision_tokenizer.layers.{i}"
        norm(f"{pre}.0.norm_media", pd)
        norm(f"{pre}.0.norm_latents", pd)
        lin(f"{pre}.0.to_q", inner, pd, bias=False)
        lin(f"{pre}.0.to_kv", 2 * inner, pd, bias=False)
        lin(f"{pre}.0.to_out", pd, inner, bias=False)
        norm(f"{pre}.1.0", pd)
        lin(f"{pre}.1.1", pd * p["ff_mult"], pd, bias=False)
        lin(f"{pre}.1.3", pd, pd * p["ff_mult"], bias=False)
    norm("vision_tokenizer.norm", pd)
    lin("vision_tokenizer.projection", p["dim_inner"], pd)

    dd, nh, nkv, dh = d["hidden_size"], d["num_heads"], d["num_kv_heads"], d["head_dim"]
    extra = cfg["num_extra_tokens"]
    out.append(("lang_model.model.embed_tokens.weight", (d["vocab_size"], dd), "normal", 0.02))
    out.append(("lang_model.model.embed_tokens.additional_embedding.weight", (extra, dd),
                "normal", 0.02))
    for i in range(d["num_layers"]):
        pre = f"lang_model.model.layers.{i}"
        norm(f"{pre}.input_layernorm", dd, bias=False)
        lin(f"{pre}.self_attn.qkv_proj", (nh + 2 * nkv) * dh, dd, bias=False)
        lin(f"{pre}.self_attn.o_proj", dd, nh * dh, bias=False)
        norm(f"{pre}.post_attention_layernorm", dd, bias=False)
        lin(f"{pre}.mlp.gate_up_proj", 2 * d["intermediate_size"], dd, bias=False)
        lin(f"{pre}.mlp.down_proj", dd, d["intermediate_size"], bias=False)
    norm("lang_model.model.norm", dd, bias=False)
    lin("lang_model.lm_head", d["vocab_size"], dd)
    lin("lang_model.lm_head.additional_fc", extra, dd)

    result, offset = [], 0
    for name, shape, init, std in out:
        leaf = Leaf(name, tuple(shape), init, std, offset if init == "normal" else 0)
        if init == "normal":
            offset += leaf.numel
        result.append(leaf)
    return result


def normal_total(specs: list[Leaf]) -> int:
    return sum(leaf.numel for leaf in specs if leaf.init == "normal")


def normal_chunk(seed: int, c: int, out: torch.Tensor) -> torch.Tensor:
    """Fill ``out`` with chunk ``c`` of the flat standard normal buffer."""
    gen = torch.Generator(device=out.device).manual_seed(sub_seed(seed, 1, c))
    return out.normal_(generator=gen)


def make_weights(cfg: dict, seed: int, dtype: torch.dtype, device) -> dict[str, torch.Tensor]:
    """Every parameter of the model ``cfg`` from ``seed``, in ``dtype`` on
    ``device``: {name: tensor}; the random leaves are views of one buffer."""
    specs = leaves(cfg)
    total = normal_total(specs)
    flat = torch.empty(total, dtype=dtype, device=device)
    for c, lo in enumerate(range(0, total, CHUNK)):
        normal_chunk(seed, c, flat[lo: lo + CHUNK])
    out = {}
    for leaf in specs:
        if leaf.init == "normal":
            t = flat[leaf.offset: leaf.offset + leaf.numel].view(leaf.shape)
            if leaf.std != 1.0:
                t.mul_(leaf.std)
        else:
            t = torch.full(leaf.shape, 1.0 if leaf.init == "ones" else 0.0, dtype=dtype,
                           device=device)
        out[leaf.name] = t
    return out


def start_values(cfg: dict, seed: int, dtype, device):
    """Yield (leaf, first index, values) for every random leaf's values in
    chunk order, one chunk made at a time: the start state without holding
    all of it."""
    specs = [leaf for leaf in leaves(cfg) if leaf.init == "normal"]
    total = normal_total(specs)
    for c, lo in enumerate(range(0, total, CHUNK)):
        hi = min(lo + CHUNK, total)
        chunk = normal_chunk(seed, c, torch.empty(hi - lo, dtype=dtype, device=device))
        for leaf in specs:
            a, b = max(lo, leaf.offset), min(hi, leaf.offset + leaf.numel)
            if a < b:
                vals = chunk[a - lo: b - lo]
                yield leaf, a - leaf.offset, vals * leaf.std if leaf.std != 1.0 else vals
        del chunk

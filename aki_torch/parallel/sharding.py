"""Parameter placement rules: parameter name -> one mesh axis (or None) per
dim (counterpart of ``aki_tpu/parallel/sharding.py``).

The table is JAX's, rewritten on the port's own names (the reference
checkpoint's ``lang_model.*``, ``vision_encoder.*``, ``vision_tokenizer.*``)
and in its ``(out, in)`` weight layout, so that a JAX ``(in, out)`` spec
``("fsdp", "tensor")`` reads ``("tensor", "fsdp")`` here:

- matmul input dims shard over ``fsdp``; output dims that are heads or MLP
  columns over ``tensor`` (Megatron: q/k/v, gate/up column-parallel; o_proj,
  down_proj row-parallel);
- vocab dims over ``tensor`` for the head, ``fsdp`` for the table;
- norms and biases replicate; MoE experts shard their leading dim over
  ``expert``.

The port keeps HF Phi-3's fused ``qkv_proj`` (q | k | v rows) and
``gate_up_proj`` (gate | up rows) where JAX keeps ``wq``, ``wk``, ``wv``,
``w_gate``, ``w_up`` apart, and the Perceiver's ``to_kv`` (k | v rows) as
JAX does. A fused weight's ``tensor`` dim is split part by
part (:func:`parts_for_path`): rank r holds its heads' q, k and v, and its
columns of gate and up, never a slice across a part boundary.

What uses the table: the tensor-parallel split (:mod:`aki_torch.parallel.tensor`)
takes each weight's ``tensor`` dim from it (a column-parallel product's
bias goes with its rows). FSDP2 (:func:`aki_torch.parallel.fsdp.shard_model`)
shards every parameter of a unit on dim 0 and all-gathers whole units, so
the ``fsdp`` dim of a rule is a storage choice that changes no result there.
"""

from __future__ import annotations

import re

import torch

from ..models.configs import AKIConfig

Spec = tuple  # one mesh axis name (or None) per dim; () replicates

_LAYER = r"lang_model\.model\.layers\.\d+\."
_SIG = r"vision_encoder\.encoder\.layers\.\d+\."
_PER = r"vision_tokenizer\.layers\.\d+\."

PARAM_RULES: list[tuple[str, Spec]] = [
    # --- Phi-3 decoder ----------------------------------------------------
    (r"lang_model\.model\.embed_tokens\.weight$", ("tensor", "fsdp")),
    (_LAYER + r"(input|post_attention)_layernorm", ()),
    (_LAYER + r"self_attn\.qkv_proj\.weight$", ("tensor", "fsdp")),
    (_LAYER + r"self_attn\.o_proj\.weight$", ("fsdp", "tensor")),
    (_LAYER + r"mlp\.gate_up_proj\.weight$", ("tensor", "fsdp")),
    (_LAYER + r"mlp\.down_proj\.weight$", ("fsdp", "tensor")),
    # MoE decoder option: experts shard over the "expert" axis
    (_LAYER + r"mlp\.router\.weight$", ()),
    (_LAYER + r"mlp\.w_(gate|up)$", ("expert", "fsdp", "tensor")),
    (_LAYER + r"mlp\.w_down$", ("expert", "tensor", "fsdp")),
    (r"lang_model\.model\.norm", ()),
    # --- decoupled vocab ---------------------------------------------------
    (r"embed_tokens\.additional_embedding\.weight$", (None, "fsdp")),
    (r"lang_model\.lm_head\.weight$", ("tensor", "fsdp")),
    (r"lm_head\.additional_fc\.weight$", (None, "fsdp")),
    # --- SigLIP (frozen; sharded to save memory) ---------------------------
    # the JAX patch kernel is (kh*kw*c, out); the conv weight's input is
    # three dims here, so only its output dim carries an axis
    (r"vision_encoder\.embeddings\.patch_embedding\.weight$", ("tensor",)),
    (r"vision_encoder\.embeddings\.position_embedding\.weight$", (None, "fsdp")),
    (_SIG + r"self_attn\.[qkv]_proj\.weight$", ("tensor", "fsdp")),
    (_SIG + r"self_attn\.out_proj\.weight$", ("fsdp", "tensor")),
    (_SIG + r"mlp\.fc1\.weight$", ("tensor", "fsdp")),
    (_SIG + r"mlp\.fc2\.weight$", ("fsdp", "tensor")),
    (r"vision_encoder", ()),  # norms, biases
    # --- perceiver ----------------------------------------------------------
    (r"vision_tokenizer\.latents$", (None, "fsdp")),
    (_PER + r"0\.to_q\.weight$", ("tensor", "fsdp")),
    (_PER + r"0\.to_kv\.weight$", ("tensor", "fsdp")),
    (_PER + r"0\.to_out\.weight$", ("fsdp", "tensor")),
    (_PER + r"1\.1\.weight$", ("tensor", "fsdp")),
    (_PER + r"1\.3\.weight$", ("fsdp", "tensor")),
    (r"vision_tokenizer\.projection\.weight$", ("tensor", "fsdp")),
    (r"vision_tokenizer", ()),
    # --- default: replicate -------------------------------------------------
    (r".*", ()),
]


def _fused_rows(cfg: AKIConfig) -> list[tuple[str, tuple[int, ...]]]:
    """The fused weights' part sizes along their ``tensor`` dim (dim 0):
    q | k | v rows, gate | up rows and the Perceiver's k | v rows."""
    p = cfg.phi3
    inner = cfg.perceiver.dim_head * cfg.perceiver.heads
    return [(_LAYER + r"self_attn\.qkv_proj\.weight$",
             (p.num_heads * p.head_dim, p.num_kv_heads * p.head_dim,
              p.num_kv_heads * p.head_dim)),
            (_LAYER + r"mlp\.gate_up_proj\.weight$",
             (p.intermediate_size, p.intermediate_size)),
            (_PER + r"0\.to_kv\.weight$", (inner, inner))]


def spec_for_path(name: str, rules=None) -> Spec:
    for pat, spec in rules or PARAM_RULES:
        if re.search(pat, name):
            return spec
    return ()


def parts_for_path(name: str, cfg: AKIConfig) -> tuple[int, ...] | None:
    for pat, parts in _fused_rows(cfg):
        if re.search(pat, name):
            return parts
    return None


def fit_spec(spec: Spec, shape, sizes: dict[str, int],
             parts: tuple[int, ...] | None = None) -> Spec:
    """JAX's ``_fit_spec``: cut the spec to the tensor's dims, and replicate
    a dim whose mesh axes do not divide it (a fused dim: each of its
    ``parts``); trailing Nones dropped."""
    parts_dim = None if parts is None else 0
    fixed = []
    for d, (dim, part) in enumerate(zip(shape, list(spec) + [None] * (len(shape) - len(spec)))):
        if part is None:
            fixed.append(None)
            continue
        names = part if isinstance(part, tuple) else (part,)
        size = 1
        for n in names:
            size *= sizes.get(n, 1)
        lens = parts if d == parts_dim else (dim,)
        fixed.append(part if all(n % size == 0 for n in lens) else None)
    while fixed and fixed[-1] is None:
        fixed.pop()
    return tuple(fixed)


def strip_axis_rules(axis: str = "fsdp", rules=None) -> list[tuple[str, Spec]]:
    """Rules with ``axis`` removed from every spec (that dim replicates):
    ZeRO-2's parameter placement in JAX (``SHARD_GRAD_OP``)."""

    def strip(spec: Spec) -> Spec:
        out = []
        for part in spec:
            if part == axis:
                out.append(None)
            elif isinstance(part, tuple):
                kept = tuple(a for a in part if a != axis)
                out.append(kept if kept else None)
            else:
                out.append(part)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    return [(pat, strip(spec)) for pat, spec in (rules or PARAM_RULES)]


def local_slice(x, spec: Spec, axis: str, index: int, n: int,
                parts: tuple[int, ...] | None = None):
    """Rank ``index`` of ``n``'s block of ``x`` along the dim that ``spec``
    gives ``axis`` (``x`` itself when no dim carries it). A fused dim 0 is
    split part by part and the parts' blocks concatenated."""
    dims = [d for d, part in enumerate(spec)
            if part == axis or (isinstance(part, tuple) and axis in part)]
    if not dims:
        return x
    d = dims[0]
    pieces = torch.split(x, list(parts), dim=d) if parts is not None and d == 0 else (x,)
    return torch.cat([p.chunk(n, dim=d)[index] for p in pieces], dim=d)

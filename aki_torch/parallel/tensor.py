"""Tensor parallelism, for training and serving (counterpart of what
GSPMD does with the ``tensor`` entries of ``aki_tpu/parallel/sharding.py:
PARAM_RULES``, and of the JAX package's ``tp_mesh`` routes:
``aki_tpu/models/phi3.py:387-410``, ``aki_tpu/models/siglip.py:114-118``,
``aki_tpu/infer/server.py:285-305``).

:func:`shard_tensor_parallel` cuts each weight to this rank's block along
the ``tensor`` dim that :mod:`aki_torch.parallel.sharding` gives it
(Megatron: q/k/v, gate/up, SigLIP's q/k/v and fc1, the Perceiver's to_q,
to_kv and first FF product, the projection and the patch embedding by
rows, part by part for the fused weights, with their biases; o_proj,
down_proj, out_proj, fc2, to_out and the second FF product by columns;
the LM head by vocab rows; the MoE experts by their inner dim), so that
each rank holds whole heads and the layer code, the KV caches and the
kernels see local heads only. Attention runs on them with no collective
(the JAX package's ``flash_mma_attention_tp``, ``aki_tpu/ops/flash_mma.py:
871-913``, is the flash forward inside a ``shard_map`` over the heads;
here the heads are already local).

The collectives are differentiable and fused with their products: a
column-parallel product (:func:`column_product`: Megatron's *f*, identity
forward) sums its input's gradient over the group in the backward, a
row-parallel one (:func:`row_product`: *g*) sums its output in the
forward. Given no group (``tp=None``), or a quantized weight,
:func:`column_parallel` and :func:`row_parallel` are the whole projection,
so that a layer makes one call whether it is cut or not. Each sum adds
the ranks' f32 partial products (cuBLAS's ``out_dtype`` on the card) and
rounds once, as one card's product rounds its f32 accumulator once:
partials rounded to bf16 before a bf16 sum part from one card's training
steps 2-5x further than two bf16 implementations of one card do
(``exp_torch/tp_collectives_ab.py``). ``gather_last``
concatenates the ranks' vocab slices of the logits (or the projection's
columns) with a backward that keeps the rank's own slice: every tensor
rank computes the same loss from the same gathered logits, so the
gradient each holds of them is already the whole one (the backward of
``torch.distributed.nn.functional.all_gather`` would sum the n equal
copies). A rank's replicated weights (the norms, the row-parallel biases,
the embedding tables, the extra head, the Perceiver latents) therefore
get the same gradient on every tensor rank; the split ones their own block
of it (:class:`TensorShards`).

- A block whose head count (or MLP width) the axis does not divide is
  kept whole on every rank (``aki_tiny``'s tower and Perceiver, 2 heads,
  at ``tensor=4``): JAX's ``_fit_spec`` checks only that the dim divides,
  and GSPMD computes through a split head, which a kernel on local heads
  cannot. The decoder must divide (``ValueError``).
- The embedding tables stay whole (JAX shards them over
  ``("tensor", "fsdp")``; FSDP2 shards them over ``fsdp`` here).
- Quantized weights (:mod:`aki_torch.models.quant`) are not cut: JAX's
  ``$``-anchored rules leave a ``QuantTensor`` tree replicated, so the
  projections and the fused-quant kernels run whole on every rank, q, k
  and v are sliced to the rank's heads, attention runs on them (the flash
  forward, as JAX's TP route does, not the bf16-P serving attention), the
  int8 KV cache holds them, and the output is gathered back along the
  heads for the replicated output projection.

The weights are plain local tensors, not DTensors: the port's layers call
``F.linear`` (and the int8 ``mm``) on the weights themselves, which module
hooks such as ``parallelize_module``'s would not see. FSDP2 then shards
these local tensors over the ``(data, fsdp)`` sub-mesh.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.common import product
from ..models.quant import is_quantized, project
from .sharding import fit_spec, local_slice, parts_for_path, spec_for_path


def _matmul(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """``x @ wt`` in x's dtype: ``wt`` (in, out) for a projection of
    (..., in) rows (through :func:`~aki_torch.models.common.product`, so
    that a recomputed region keeps it as it keeps any projection), or
    (E, in, out) for batched experts (E, C, in)."""
    if wt.dim() == 3:
        return torch.bmm(x, wt)
    return product(F.linear, x, wt.t())


def _matmul_f32(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """``x @ wt`` with an f32 result: bf16 / f16 operands on a card
    accumulate in f32 and are not rounded (cuBLAS's ``out_dtype``), other
    operands are multiplied in f32. A partial product that the group then
    sums is rounded once, after the sum, as one card's product is."""
    batched = wt.dim() == 3
    x2 = x if batched else x.reshape(-1, x.shape[-1])
    mm = torch.bmm if batched else torch.mm
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        y = mm(x2, wt, out_dtype=torch.float32)
    else:
        y = mm(x2.float(), wt.float())
    return y if batched else y.reshape(*x.shape[:-1], wt.shape[-1])


def _weight_grad(x: torch.Tensor, g: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """The gradient of ``wt`` in ``x @ wt`` from the output's gradient g."""
    if wt.dim() == 3:
        return torch.bmm(x.mT, g)
    return x.reshape(-1, x.shape[-1]).t() @ g.reshape(-1, g.shape[-1])


def _sum_f32(y: torch.Tensor, group, dtype: torch.dtype) -> torch.Tensor:
    """The f32 partials ``y`` summed over the group (in place), in ``dtype``."""
    dist.all_reduce(y, group=group)
    return y.to(dtype)


class _ColumnParallel(torch.autograd.Function):
    """``x @ wt`` on the rank's output columns (Megatron's f fused with the
    product): the input's gradient is the sum over the group of the ranks'
    f32 partial products, rounded once."""

    @staticmethod
    def forward(ctx, x, wt, group):
        ctx.save_for_backward(x, wt)
        ctx.group = group
        return _matmul(x, wt)

    @staticmethod
    def backward(ctx, g):
        x, wt = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _sum_f32(_matmul_f32(g, wt.mT), ctx.group, x.dtype)
        if ctx.needs_input_grad[1]:
            gw = _weight_grad(x, g, wt)
        return gx, gw, None


class _RowParallel(torch.autograd.Function):
    """``x @ wt`` over the rank's input rows (Megatron's g fused with the
    product): the ranks' f32 partial products summed over the group and
    rounded once; the backward needs no collective."""

    @staticmethod
    def forward(ctx, x, wt, group):
        ctx.save_for_backward(x, wt)
        return _sum_f32(_matmul_f32(x, wt), group, x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, wt = ctx.saved_tensors
        gx = _matmul(g, wt.mT) if ctx.needs_input_grad[0] else None
        gw = _weight_grad(x, g, wt) if ctx.needs_input_grad[1] else None
        return gx, gw, None


class _GatherLast(torch.autograd.Function):
    """The ranks' slices concatenated along the last dim; the backward keeps
    this rank's slice of the gradient (every rank holds the whole one)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.n = tp, x.shape[-1]
        return tp.all_gather_last(x)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.tp.rank, ctx.n
        return g[..., r * n:(r + 1) * n].contiguous(), None


@dataclasses.dataclass
class TensorParallel:
    """This rank's place on the ``tensor`` axis and its collectives."""

    group: dist.ProcessGroup
    rank: int
    size: int

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` concatenated along the last dim, in rank order;
        the backward keeps this rank's slice."""
        return _GatherLast.apply(x, self)

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Concatenate the ranks' ``x`` along the last dim, in rank order."""
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=-1)

    def heads(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the heads of ``x`` (..., H, D)."""
        return x.chunk(self.size, dim=-2)[self.rank]


def column_product(x: torch.Tensor, wt: torch.Tensor,
                   tp: TensorParallel | None) -> torch.Tensor:
    """A column-parallel product ``x @ wt`` (``wt`` the rank's output
    columns: (in, out / n), or (E, in, out / n) for experts); the plain
    product when ``tp`` is None."""
    if tp is None:
        return _matmul(x, wt)
    return _ColumnParallel.apply(x, wt, tp.group)


def row_product(x: torch.Tensor, wt: torch.Tensor, tp: TensorParallel | None) -> torch.Tensor:
    """A row-parallel product ``x @ wt`` (``x`` and ``wt`` the rank's block
    of the inner dim), summed over the group; the plain product when ``tp``
    is None."""
    if tp is None:
        return _matmul(x, wt)
    return _RowParallel.apply(x, wt, tp.group)


def column_parallel(lin, x: torch.Tensor, policy, tp: TensorParallel | None) -> torch.Tensor:
    """A column-parallel ``nn.Linear`` (the rank's rows of the weight and of
    the bias); the whole projection (:func:`~aki_torch.models.quant.project`)
    when ``tp`` is None or the weight is quantized (kept whole)."""
    if tp is None or is_quantized(lin):
        return project(lin, x, policy)
    y = column_product(x, policy.cast(lin.weight).t(), tp)
    return y if lin.bias is None else y + policy.cast(lin.bias)


def row_parallel(lin, x: torch.Tensor, policy, tp: TensorParallel | None) -> torch.Tensor:
    """A row-parallel ``nn.Linear``: the ranks' partial products summed,
    then the (replicated) bias added once; the whole projection when ``tp``
    is None or the weight is quantized."""
    if tp is None or is_quantized(lin):
        return project(lin, x, policy)
    y = row_product(x, policy.cast(lin.weight).t(), tp)
    return y if lin.bias is None else y + policy.cast(lin.bias)


@dataclasses.dataclass
class TensorShards:
    """The weights a model holds a ``tensor`` block of (for checkpoints and
    the clip's norm): each name's split dim and fused parts, the group,
    this rank and the axis size."""

    names: dict          # name -> (dim, parts or None)
    group: object
    rank: int
    size: int

    def gather(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """The whole tensor of this rank's block ``t`` of ``name``
        (collective); a fused dim is put back part by part."""
        dim, parts = self.names[name]
        pieces = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(pieces, t.contiguous(), group=self.group)
        if parts is None:
            return torch.cat(pieces, dim=dim)
        local = [p // self.size for p in parts]
        split = [torch.split(p, local, dim=dim) for p in pieces]
        return torch.cat([torch.cat([s[i] for s in split], dim=dim)
                          for i in range(len(parts))], dim=dim)

    def local(self, full: torch.Tensor, name: str) -> torch.Tensor:
        dim, parts = self.names[name]
        spec = (None,) * dim + ("tensor",)
        return local_slice(full, spec, "tensor", self.rank, self.size, parts)


def _divides(n: int, *counts: int) -> bool:
    return all(c % n == 0 for c in counts)


def _split_blocks(model, n: int) -> dict[str, bool]:
    """Which blocks of ``model`` the ``tensor`` axis of size ``n`` cuts:
    the decoder always (its heads, KV heads and MLP width must divide:
    ``ValueError``), the tower and the Perceiver where their heads and
    widths divide, whole otherwise."""
    p, s, r = model.cfg.phi3, model.cfg.siglip, model.cfg.perceiver
    inter = p.moe.intermediate_size if p.moe is not None else p.intermediate_size
    for what, count in (("num_heads", p.num_heads), ("num_kv_heads", p.num_kv_heads),
                        ("intermediate_size", inter)):
        if count % n:
            raise ValueError(f"{what}={count} must divide the 'tensor' axis ({n})")
    return {"lang_model": True,
            "vision_encoder": _divides(n, s.num_heads, s.intermediate_size),
            "vision_tokenizer": _divides(n, r.heads, r.dim * r.ff_mult, r.dim_inner)}


def shard_tensor_parallel(model, mesh):
    """Cut ``model`` to this rank's ``tensor`` block, in place; returns the
    model. Sets each cut block's :class:`TensorParallel` (``.tp`` of the
    decoder, the head, the tower, the Perceiver and each MoE layer) and the
    model's :class:`TensorShards` (``model.tensor_shards``); the decoder's
    ``cfg`` becomes the local head (and, for float weights, column) counts.
    Quantized weights stay whole (the module docstring)."""
    from ..models.moe import MoEMLP

    n, rank = mesh.shape["tensor"], mesh.coord("tensor")
    cfg = model.cfg
    p = cfg.phi3
    blocks = _split_blocks(model, n)
    tp = TensorParallel(mesh.group("tensor"), rank, n)
    lm = model.lang_model
    dense_mlp = p.moe is None and not is_quantized(lm.model.layers[0].mlp["down_proj"])
    names: dict = {}
    with torch.no_grad():
        weights = dict(model.named_parameters())
        for name, param in weights.items():
            if not blocks[name.split(".")[0]]:
                continue
            if name.endswith(".bias"):
                # a column-parallel product's bias goes with its rows
                wname = name[: -len("bias")] + "weight"
                if wname not in weights or names.get(wname, (None,))[0] != 0:
                    continue
                dim, parts = 0, names[wname][1]
            else:
                if name.endswith("embed_tokens.weight") or "additional" in name:
                    continue  # the tables and the extra head stay whole
                parts = parts_for_path(name, cfg)
                spec = fit_spec(spec_for_path(name), param.shape, mesh.shape, parts)
                dims = [d for d, a in enumerate(spec) if a == "tensor"]
                if not dims:
                    continue
                dim = dims[0]
            names[name] = (dim, parts)
            param.data = local_slice(param.data, (None,) * dim + ("tensor",), "tensor",
                                     rank, n, parts).contiguous()
    lm.model.cfg = dataclasses.replace(
        p, num_heads=p.num_heads // n, num_kv_heads=p.num_kv_heads // n,
        intermediate_size=p.intermediate_size // n if dense_mlp else p.intermediate_size)
    lm.model.tp = tp
    lm.lm_head.tp = tp if "lang_model.lm_head.weight" in names else None
    model.vision_encoder.tp = tp if blocks["vision_encoder"] else None
    model.vision_tokenizer.tp = tp if blocks["vision_tokenizer"] else None
    for m in lm.modules():
        if isinstance(m, MoEMLP):
            m.tp = tp
    model.tensor_shards = TensorShards(names, tp.group, rank, n)
    return model

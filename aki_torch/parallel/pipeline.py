"""Pipeline parallelism of the decoder over the ``pipe`` axis (counterpart
of ``aki_tpu/parallel/pipeline.py``).

Each rank of the axis is one stage and keeps its L/P consecutive decoder
layers (:func:`shard_pipeline`; the others are dropped, and FSDP2 then
shards the stage's layers over ``fsdp``, gathered per layer). The batch is
cut into M microbatches that flow stage to stage in a GPipe schedule of
M + P - 1 ticks: stage s runs microbatch m at tick m + s, receiving it from
stage s - 1 and sending it on to s + 1.

- What travels is what carries a gradient: the activations and the
  running MoE aux loss. JAX's payload also carries the positions, the MMA
  spec and the key validity; the ranks of a pipe hold the same batch rows,
  so each stage slices those from its own copy.
- Every send and receive is a ``torch.autograd.Function`` whose backward
  is the reverse transfer (the gradient goes back to the stage that sent
  the activations). Autograd runs a rank's backward in the reverse order
  of its forward (microbatch M-1 first), the same order on every stage, so
  the transfers meet and cannot deadlock.
- The last stage's hidden states are broadcast to every rank of the pipe,
  which all compute the same loss (JAX's masked psum): the broadcast's
  backward keeps the last stage's own gradient (the copies are the same),
  and the pipe's input gives its gradient, from stage 0, to every rank, so
  the weights outside the pipe get the same gradient on every stage.
- The aux is summed over the microbatches and divided by M, then averaged
  over the batch ranks, as ``pipeline.py:211-220`` does. Inside the pipe a
  MoE layer routes each microbatch's own tokens, as JAX's does (its
  ``expert`` axis is not used in the pipe).

``tensor`` or ``seq`` > 1, ``expert`` > 1, layers that do not split evenly
over the stages, and a local batch that the microbatches do not divide
raise ``ValueError`` (``pipeline.py:106-130``). Training only.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn

from .mesh import BATCH_AXES, Mesh


@dataclasses.dataclass
class PipeStage:
    """This rank's stage: the pipe group, its rank and size, the
    microbatches, its layers' global indices and the batch group (for the
    aux's mean)."""

    group: object
    rank: int
    size: int
    microbatches: int
    layers: range
    batch_group: object = None
    n_batch: int = 1

    def peer(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)


class _Send(torch.autograd.Function):
    """Send the payload to the next stage; returns a 0-d token whose
    backward receives the payload's gradient from that stage."""

    @staticmethod
    def forward(ctx, pipe, h, a):
        ctx.pipe, ctx.shapes = pipe, (h.shape, h.dtype, a.dtype)
        dst = pipe.peer(pipe.rank + 1)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, h.contiguous(), dst, pipe.group),
                dist.P2POp(dist.isend, a.reshape(1).contiguous(), dst, pipe.group)]):
            req.wait()
        return h.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        pipe, (shape, dt, adt) = ctx.pipe, ctx.shapes
        src = pipe.peer(pipe.rank + 1)
        dh = torch.empty(shape, dtype=dt, device=_.device)
        da = torch.empty(1, dtype=adt, device=_.device)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.irecv, dh, src, pipe.group),
                                           dist.P2POp(dist.irecv, da, src, pipe.group)]):
            req.wait()
        return None, dh, da.reshape(())


class _Recv(torch.autograd.Function):
    """Receive the payload from the previous stage; the backward sends its
    gradient back there."""

    @staticmethod
    def forward(ctx, pipe, anchor, shape, dtype):
        ctx.pipe = pipe
        src = pipe.peer(pipe.rank - 1)
        h = torch.empty(shape, dtype=dtype, device=anchor.device)
        a = torch.empty(1, dtype=torch.float32, device=anchor.device)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.irecv, h, src, pipe.group),
                                           dist.P2POp(dist.irecv, a, src, pipe.group)]):
            req.wait()
        return h, a.reshape(())

    @staticmethod
    def backward(ctx, dh, da):
        pipe = ctx.pipe
        dst = pipe.peer(pipe.rank - 1)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, dh.contiguous(), dst, pipe.group),
                dist.P2POp(dist.isend, da.reshape(1).contiguous(), dst, pipe.group)]):
            req.wait()
        return None, None, None, None


class _PipeInput(torch.autograd.Function):
    """The pipe's input, the same on every stage: stage 0 consumes it, and
    the backward gives stage 0's gradient to every stage."""

    @staticmethod
    def forward(ctx, x, pipe):
        ctx.pipe = pipe
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.broadcast(g, ctx.pipe.peer(0), group=ctx.pipe.group)
        return g, None


class _PipeOutput(torch.autograd.Function):
    """The last stage's output on every stage (a broadcast); its backward
    keeps the last stage's own gradient, the copies being the same. The
    sentinel ties the stage's sends into the graph."""

    @staticmethod
    def forward(ctx, h, sentinel, pipe, shape, dtype):
        ctx.pipe = pipe
        out = h.clone() if pipe.rank == pipe.size - 1 else torch.empty(
            shape, dtype=dtype, device=sentinel.device)
        dist.broadcast(out, pipe.peer(pipe.size - 1), group=pipe.group)
        return out

    @staticmethod
    def backward(ctx, g):
        last = ctx.pipe.rank == ctx.pipe.size - 1
        return g if last else None, torch.zeros((), device=g.device), None, None, None


class _BatchMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out / n

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g / ctx.n, None, None


def phi3_forward_pp(decoder, inputs_embeds, positions, spec, kv_valid, policy, use_flash,
                    remat: bool, remat_policy: str, with_aux: bool):
    """Training forward of ``decoder`` (a :class:`~aki_torch.models.phi3.Phi3Model`
    cut by :func:`shard_pipeline`) with pipelined layers: the same contract
    as its no-cache forward; returns (final-normed hidden states, None, the
    summed MoE aux or 0) on every stage."""
    from ..models.common import remat_call, rmsnorm
    from ..models.phi3 import fused_parts
    from ..ops.masks import MMASpec
    from ..ops.rope import rope_cos_sin

    pipe: PipeStage = decoder.pipe
    cfg = decoder.cfg
    m = pipe.microbatches
    x = inputs_embeds.to(policy.compute_dtype)
    b = x.shape[0]
    if b % m:
        raise ValueError(f"the local batch {b} must divide num_microbatches={m}")
    bm = b // m
    x = _PipeInput.apply(x, pipe)
    cos, sin = rope_cos_sin(cfg.rope, positions)
    spec = spec.with_batch_dim() if spec is not None else None
    parts = fused_parts(cfg)
    layers = list(decoder.layers.values())
    first, last = pipe.rank == 0, pipe.rank == pipe.size - 1
    anchor = torch.zeros((), device=x.device, requires_grad=True)
    outs, auxs, sends = [], [], []
    for mb in range(m):
        rows = slice(mb * bm, (mb + 1) * bm)
        if first:
            h, a = x[rows], torch.zeros((), dtype=torch.float32, device=x.device)
        else:
            h, a = _Recv.apply(pipe, anchor, (bm,) + tuple(x.shape[1:]), x.dtype)
        sp = None if spec is None else MMASpec(spec.img_start[rows], spec.txt_start[rows],
                                               spec.txt_end[rows])
        kvv = None if kv_valid is None else kv_valid[rows]
        for li, layer in zip(pipe.layers, layers):
            h, la = remat_call(remat, remat_policy, layer, h, cos[rows], sin[rows], cfg, sp,
                               kvv, 0, None, li, policy, use_flash, None, None, parts=parts)
            if la is not None:
                a = a + la
        if last:
            outs.append(h)
            auxs.append(a)
        else:
            sends.append(_Send.apply(pipe, h, a))
    # ties this stage's sends, and on stages past the first the pipe's input
    # (whose backward is a broadcast every stage joins), into the graph
    sentinel = torch.stack(sends).sum() if sends else anchor * 0
    if not first:
        sentinel = sentinel + 0 * x.reshape(-1)[:1].sum().float()
    hidden = _PipeOutput.apply(torch.cat(outs) if last else anchor, sentinel, pipe,
                               tuple(x.shape), x.dtype)
    aux_local = (torch.stack(auxs).sum() if last else anchor * 0).reshape(1) / m
    aux = _PipeOutput.apply(aux_local, sentinel * 0, pipe, (1,), torch.float32).reshape(())
    if pipe.n_batch > 1:
        aux = _BatchMean.apply(aux, pipe.batch_group, pipe.n_batch)
    hidden = rmsnorm(policy.cast(decoder.norm.weight), hidden, cfg.rms_norm_eps)
    return (hidden, None, aux) if with_aux else (hidden, None)


def shard_pipeline(model, mesh: Mesh, microbatches: int | None = None) -> None:
    """Keep this rank's stage of ``model``'s decoder layers (in place, before
    FSDP2 wraps them) and route its decoder through :func:`phi3_forward_pp`.
    ``microbatches`` defaults to the number of stages, as in JAX."""
    n_pipe = mesh.shape["pipe"]
    for ax in ("tensor", "seq", "expert"):
        if mesh.shape[ax] != 1:
            raise ValueError(f"pipeline composes with data/fsdp only; mesh has "
                             f"{ax}={mesh.shape[ax]} (> 1 unsupported)")
    decoder = model.lang_model.model
    n_layers = decoder.cfg.num_layers
    if n_layers % n_pipe:
        raise ValueError(f"num_layers={n_layers} must split evenly over pipe={n_pipe} stages")
    stage = mesh.coord("pipe")
    per = n_layers // n_pipe
    mine = range(stage * per, (stage + 1) * per)
    decoder.layers = nn.ModuleDict({str(i): decoder.layers[i] for i in mine})
    n_batch = mesh.size(*BATCH_AXES)
    decoder.pipe = PipeStage(mesh.group("pipe"), stage, n_pipe, microbatches or n_pipe, mine,
                             mesh.group(*BATCH_AXES) if n_batch > 1 else None, n_batch)


def decoder_layers(decoder):
    """The decoder's layers: all of them, or a pipeline stage's."""
    layers = decoder.layers
    return list(layers.values()) if isinstance(layers, nn.ModuleDict) else list(layers)

"""The MoE decoder over split tokens and the ``expert`` axis (counterpart
of ``aki_tpu/models/moe.py:122-127`` under GSPMD).

Under GSPMD JAX's ``moe_mlp`` sees the global token set (the batch split
over ``data``/``fsdp``, the sequence over ``seq``), so its capacity, each
choice's place and which choices drop are global. Here each rank holds its
tokens only; :class:`MoEParallel` (set on each layer's ``MoEMLP.par`` by
:func:`shard_experts`) gives it the global ones:

- the places: every rank's expert choices (k ints a token) are gathered,
  put in the global token order (rows, then positions), placed choice-major
  as JAX places them, and each rank keeps its own tokens' places;
- the capacity counts the global tokens;
- the Switch aux takes its two means over the global tokens: the first
  choices' counts summed over the ranks, and the router probabilities
  summed by a differentiable all-reduce (its backward sums too, as each
  rank's loss is its share of the global loss).

Each rank dispatches its own tokens only: they keep their order inside the
global set, so an expert's kept choices are the first of the rank's own
choices of it, and their places among those are their slots in a buffer of
``min(cap, N)`` rows an expert (``models/moe.py``). An expert's output for
a row depends on that row alone, so no rank needs another's tokens: the
token ranks exchange the choices (k ints a token) and the aux's two sums,
nothing of width D.

With ``expert`` > 1 each rank keeps E/n of the stacked expert weights
(JAX's rules shard their leading dim over ``expert``). The batch is not
split over ``expert`` (JAX's ``BATCH_AXES`` are data and fsdp), so the
expert ranks hold the same tokens and the same buffer: the ``all_to_all``
that would send each expert's rows to the rank holding it is a slice
here, and the way back an all-gather of the outputs over the expert
ranks, ``(n - 1) / n`` of the ``(E, min(cap, N), D)`` output buffer a rank
and layer. As the expert ranks compute the same thing, the gather's
backward keeps the rank's own rows and the slice's backward all-gathers.
"""

from __future__ import annotations

import dataclasses
import re

import torch
import torch.distributed as dist

from .mesh import BATCH_AXES, Mesh

EXPERT_PARAM = re.compile(r"lang_model\.model\.layers\.\d+\.mlp\.w_(gate|up|down)$")


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ExpertSlice(torch.autograd.Function):
    """This rank's experts' rows of a buffer every expert rank holds."""

    @staticmethod
    def forward(ctx, x, par):
        ctx.par = par
        n = x.shape[0] // par.ep_size
        return x[par.ep_rank * n:(par.ep_rank + 1) * n].clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.par.all_gather_experts(g.contiguous()), None


class _ExpertGather(torch.autograd.Function):
    """The expert ranks' outputs concatenated along the experts."""

    @staticmethod
    def forward(ctx, x, par):
        ctx.par, ctx.n = par, x.shape[0]
        return par.all_gather_experts(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        n, r = ctx.n, ctx.par.ep_rank
        return g[r * n:(r + 1) * n].contiguous(), None


@dataclasses.dataclass
class MoEParallel:
    """This rank's view of the global tokens and of the experts:
    ``token_group`` the ranks whose tokens make the global set
    (``n_batch`` x ``n_seq`` of them, this rank at ``(batch_index,
    seq_index)``), ``ep_group`` the ranks of the ``expert`` axis."""

    token_group: object
    n_batch: int
    n_seq: int
    batch_index: int
    seq_index: int
    ep_group: object = None
    ep_rank: int = 0
    ep_size: int = 1

    @property
    def tokens(self) -> int:
        """The number of ranks over which the tokens are split."""
        return self.n_batch * self.n_seq

    def global_positions(self, top_idx: torch.Tensor, e: int, rows: int) -> torch.Tensor:
        """This rank's tokens' places (N, k) among the global tokens'."""
        from ..models.moe import positions

        parts = [torch.empty_like(top_idx) for _ in range(self.tokens)]
        dist.all_gather(parts, top_idx.contiguous(), group=self.token_group)
        k = top_idx.shape[1]
        t = top_idx.shape[0] // rows
        # group rank g is (batch g // n_seq, seq g % n_seq): global order is
        # batch rank, row, seq rank, position
        order = (torch.stack(parts).reshape(self.n_batch, self.n_seq, rows, t, k)
                 .permute(0, 2, 1, 3, 4).reshape(-1, k))
        pos = positions(order, e).reshape(self.n_batch, rows, self.n_seq, t, k)
        return pos[self.batch_index, :, self.seq_index].reshape(rows * t, k)

    def global_means(self, onehot_first: torch.Tensor, probs: torch.Tensor):
        """The aux's means over the global tokens: of the first choices'
        one-hot (N, E) (no gradient) and of the probabilities (N, E)."""
        n = onehot_first.shape[0] * self.tokens
        counts = onehot_first.sum(0)
        dist.all_reduce(counts, group=self.token_group)
        return counts / n, _AllReduceSum.apply(probs.sum(0), self.token_group) / n

    def experts_rows(self, buf: torch.Tensor) -> torch.Tensor:
        """This rank's experts' rows (E/n, C, D) of the dispatched buffer
        (E, C, D)."""
        return _ExpertSlice.apply(buf, self)

    def gather_experts(self, out: torch.Tensor) -> torch.Tensor:
        return _ExpertGather.apply(out, self)

    def all_gather_experts(self, x: torch.Tensor) -> torch.Tensor:
        out = x.new_empty((self.ep_size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=self.ep_group)
        return out


@dataclasses.dataclass
class ExpertShards:
    """The expert weights a model holds a block of (for checkpoints and the
    clip's norm): their names, the expert group, rank and size."""

    names: set
    group: object
    rank: int
    size: int

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole (E, ...) tensor of this rank's block (collective)."""
        out = t.new_empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t.contiguous(), group=self.group)
        return out

    def local(self, full: torch.Tensor) -> torch.Tensor:
        return full.chunk(self.size)[self.rank]


def moe_parallel(mesh: Mesh) -> MoEParallel:
    """This rank's :class:`MoEParallel` on ``mesh``: the tokens split over
    the batch axes and ``seq``, the experts over ``expert``."""
    n_e = mesh.shape["expert"]
    n_b, n_s = mesh.size(*BATCH_AXES), mesh.shape["seq"]
    return MoEParallel(
        token_group=mesh.group(*BATCH_AXES, "seq") if n_b * n_s > 1 else None,
        n_batch=n_b, n_seq=n_s, batch_index=mesh.index(*BATCH_AXES),
        seq_index=mesh.coord("seq"),
        ep_group=mesh.group("expert") if n_e > 1 else None, ep_rank=mesh.coord("expert"),
        ep_size=n_e)


def shard_experts(model, mesh: Mesh) -> None:
    """Give each MoE layer of ``model`` its :class:`MoEParallel` and, with
    ``expert`` > 1, keep this rank's E/n experts of its stacked weights (in
    place; before FSDP2 wraps the layers)."""
    from ..models.moe import MoEMLP

    moe_cfg = model.cfg.phi3.moe
    n_e, r_e = mesh.shape["expert"], mesh.coord("expert")
    if moe_cfg.num_experts % n_e:
        raise ValueError(f"num_experts={moe_cfg.num_experts} must divide the 'expert' axis "
                         f"({n_e})")
    par = moe_parallel(mesh)
    names = set()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if n_e > 1 and EXPERT_PARAM.search(name):
                p.data = p.data.chunk(n_e)[r_e].contiguous()
                names.add(name)
    for m in model.modules():
        if isinstance(m, MoEMLP):
            m.par = par
    if n_e > 1:
        model.expert_shards = ExpertShards(names, par.ep_group, r_e, n_e)

"""Ring sequence-parallel MMA attention (counterpart of
``aki_tpu/ops/ring_attention.py``) and the decoder's sequence-parallel
context.

Under the ``seq`` mesh axis each rank holds T/n consecutive rows of the
spliced sequence. :func:`ring_mma_attention_sp` keeps K/V sharded: in each
of n steps the local query rows attend to one resident K/V block, which
then moves a hop around the ring (rank i sends to i+1). The backward is its
own reverse ring, rotating (k, v, dk, dv) as a unit, so that after n hops
every block and its summed gradient are home again. No rank ever holds more
than T/n keys.

As in JAX, the block attention is plain tensor code (an online softmax over
blocks with f32 statistics), not a kernel: JAX computes it with XLA einsums
(``ring_attention.py:20-26``). The mask of a block is
``masks.allowed_mask`` with ``kv_offset`` giving the block its absolute key
positions. A block no query row may attend is skipped; which blocks live is
read once per forward from the host copy of the spec and the key validity
(:class:`SeqShard`), not with a device sync per block. The ring still
rotates n times, so every rank issues the same communication.

``SP_IMPL`` picks the decoder's route: ``"ring"`` (this module) or
``"allgather"`` (:func:`~aki_torch.ops.flash_mma.flash_mma_attention_sp`:
K/V gathered along T, the flash kernels on the local query rows).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from .masks import MMASpec, allowed_mask

__all__ = ["ring_mma_attention_sp", "SP_IMPL", "SeqShard"]

SP_IMPL = "ring"
LAST_SHARD = None   # the newest SeqShard, for checks (the K/V rows it saw)

NEG_INF = -1e30
_FLOOR = -1e30  # finite exponent floor: exp(x - _FLOOR) == 0 for x ~ NEG_INF


@dataclasses.dataclass
class SeqShard:
    """This rank's place on the ``seq`` axis for one forward: the group,
    its rank and size, the local rows ``[rank*tl, (rank+1)*tl)`` of a
    spliced sequence of ``t`` rows, the global spec and key validity (B, T),
    and ``live[i, j]``: may some row of shard i attend to a key of shard j
    (from the host copies)."""

    group: dist.ProcessGroup
    rank: int
    size: int
    t: int
    spec: MMASpec
    kv_valid: torch.Tensor
    live: np.ndarray
    impl: str = "ring"
    # local K/V row counts seen by the attention, for checks
    seen_kv_rows: list = dataclasses.field(default_factory=list)

    @property
    def tl(self) -> int:
        return self.t // self.size

    @property
    def lo(self) -> int:
        return self.rank * self.tl

    @staticmethod
    def create(group, t: int, spec: MMASpec, kv_valid: torch.Tensor,
               impl: str | None = None) -> "SeqShard":
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        if t % n:
            raise ValueError(
                f"sequence length {t} must divide the 'seq' axis ({n}); pad the spliced "
                f"sequence to a multiple (the data layer's length buckets can guarantee this)")
        spec_h = MMASpec(*(x.cpu() for x in (spec.img_start, spec.txt_start, spec.txt_end)))
        ok = allowed_mask(spec_h, t, t, kv_valid.cpu()).numpy()      # (B, T, T)
        tl = t // n
        live = ok.reshape(ok.shape[0], n, tl, n, tl).any(axis=(0, 2, 4))
        global LAST_SHARD
        LAST_SHARD = SeqShard(group, rank, n, t, spec, kv_valid, live, impl or SP_IMPL)
        return LAST_SHARD

    def attend(self, q, k, v, scale=None):
        """The local rows' attention by this shard's route."""
        if self.impl == "ring":
            return ring_mma_attention_sp(q, k, v, self, scale=scale)
        if self.impl == "allgather":
            from .flash_mma import flash_mma_attention_sp

            return flash_mma_attention_sp(q, k, v, self, scale=scale)
        raise ValueError(f"SP_IMPL {self.impl!r}: 'ring' or 'allgather'")


def _rotate(xs, group, rank: int, n: int):
    """One ring hop: rank i's tensors move to rank (i + 1) % n."""
    nxt = dist.get_global_rank(group, (rank + 1) % n)
    prv = dist.get_global_rank(group, (rank - 1) % n)
    outs = [torch.empty_like(x) for x in xs]
    ops = []
    for x, o in zip(xs, outs):
        ops += [dist.P2POp(dist.isend, x.contiguous(), nxt, group),
                dist.P2POp(dist.irecv, o, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def _block_ok(sh: SeqShard, src: int) -> torch.Tensor:
    """(B, Tq, Tk) mask of the local rows against shard ``src``'s keys."""
    tl = sh.tl
    kvv = sh.kv_valid[:, src * tl:(src + 1) * tl]
    return allowed_mask(sh.spec, tl, tl, kvv, q_offset=sh.lo, kv_offset=src * tl)


def _scores(q, k_c, ok, scale):
    """Masked (B, H, Tq, Tk) f32 scores of the operands' exact products."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_c.float())
    return torch.where(ok[:, None], s * scale, NEG_INF)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sh: SeqShard, scale: float):
        b, tl, h, _ = q.shape
        n, me = sh.size, sh.rank
        o = torch.zeros((b, h, tl, v.shape[-1]), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, tl), NEG_INF, dtype=torch.float32, device=q.device)
        l_ = torch.zeros((b, h, tl), dtype=torch.float32, device=q.device)
        k_c, v_c = k, v
        for s_idx in range(n):
            src = (me - s_idx) % n
            sh.seen_kv_rows.append(k_c.shape[1])
            if sh.live[me, src]:
                s = _scores(q, k_c, _block_ok(sh, src), scale)
                m_new = torch.maximum(m, s.amax(-1))
                m_ref = torch.clamp(m_new, min=_FLOOR)
                p = torch.exp(s - m_ref[..., None])
                corr = torch.exp(m - m_ref)
                l_ = l_ * corr + p.sum(-1)
                o = o * corr[..., None] + torch.einsum(
                    "bhqk,bkhd->bhqd", p.to(v_c.dtype).float(), v_c.float())
                m = m_new
            if s_idx < n - 1:
                k_c, v_c = _rotate((k_c, v_c), sh.group, me, n)
        out_n = o / torch.clamp(l_, min=1e-30)[..., None]
        lse = torch.where(l_ > 0, torch.clamp(m, min=_FLOOR)
                          + torch.log(torch.clamp(l_, min=1e-30)), 0.0)
        ctx.save_for_backward(q, k, v, out_n, lse)
        ctx.sh, ctx.scale = sh, scale
        return out_n.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out_n, lse = ctx.saved_tensors
        sh, scale = ctx.sh, ctx.scale
        n, me = sh.size, sh.rank
        gt = g.float().transpose(1, 2)                   # (B, H, T, D)
        delta = (gt * out_n).sum(-1)
        gt_c = gt.to(q.dtype).float()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_c = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_c = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_c, v_c = k, v
        qf = q.float()
        for s_idx in range(n):
            src = (me - s_idx) % n
            if sh.live[me, src]:
                s = _scores(q, k_c, _block_ok(sh, src), scale)
                p = torch.exp(s - lse[..., None])
                pc = p.to(q.dtype).float()
                dv_c = dv_c + torch.einsum("bhqk,bhqd->bkhd", pc, gt_c)
                dp = torch.einsum("bhqd,bkhd->bhqk", gt_c, v_c.float())
                ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
                dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, k_c.float())
                dk_c = dk_c + torch.einsum("bhqk,bqhd->bkhd", ds, qf)
            # the blocks and their gradient sums move as a unit: after n
            # hops each block's dk/dv are home
            k_c, v_c, dk_c, dv_c = _rotate((k_c, v_c, dk_c, dv_c), sh.group, me, n)
        return dq.to(q.dtype), dk_c.to(k.dtype), dv_c.to(v.dtype), None, None


def ring_mma_attention_sp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          shard: SeqShard, scale: float | None = None) -> torch.Tensor:
    """Attention of this rank's rows q (B, T/n, H, D) over the whole
    sequence, K/V (B, T/n, H, D) staying sharded. Differentiable in q, k, v.
    GQA K/V are repeated to q's heads first."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    return _Ring.apply(q, k, v, shard, float(scale))

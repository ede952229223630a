"""Mixture-of-Experts MLP of the decoder (counterpart of
``aki_tpu/models/moe.py``), chosen by ``Phi3Config.moe``.

- **Routing**: router logits in f32 from operands in the compute dtype,
  softmax, top-k, the k gates renormalised over the chosen experts. Each
  (token, choice) takes the next place in its expert's buffer, the k choices
  taken in turn over all tokens (choice-major), so that first choices fill
  before second choices; a choice past the capacity is dropped.
- **Scatter dispatch** (default): the kept choices' rows are written into a
  zeroed ``(E * cap + 1, D)`` buffer at ``expert * cap + place``; every
  dropped choice writes the extra last row (the JAX scatter's
  ``mode="drop"``), which is sliced off. The places are unique, so nothing
  collides but the dropped rows, and nothing waits for the host. The expert
  outputs come back by a gather from the buffer with a zero row appended.
- **Dense dispatch** (``dispatch="dense"``): the one-hot ``(N, E, C)``
  einsum, kept as the oracle of the scatter.
- **Aux loss** (Switch): ``E * sum(frac_tokens * frac_router_prob)`` over
  every token given, padding included, as in JAX.

The expert products are ``torch.bmm`` over the stacked ``(E, ...)`` weights.

Sharded (``MoEMLP.par``, a :class:`~aki_torch.parallel.expert.MoEParallel`
set by :func:`~aki_torch.parallel.expert.shard_experts`): under GSPMD
JAX's layer sees the global token set, so the capacity, each choice's
place and which choices drop are global. Each rank gathers the ranks'
expert choices (a few ints a token), places them in the global token order
and keeps its own tokens' places; the capacity counts the global tokens;
the aux takes its two means over them. The buffer holds this rank's rows
only: a rank's tokens keep their order inside the global set, so the kept
choices of an expert are the first of the rank's own choices of it, and
their places among those (below ``min(cap, N)``) are their slots. With the
``expert`` axis each rank holds E/n experts and runs them on their rows of
its buffer, and the outputs are gathered over the expert ranks (which hold
the same tokens).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .common import empty, init_normal, product
from .configs import MoEConfig

DISPATCHES = ("scatter", "dense")


def capacity(n_tok: int, cfg: MoEConfig) -> int:
    """Slots per expert: ``ceil(n_tok * k * capacity_factor / E)``, at
    least 1, in the JAX module's own float expression (so that a product
    such as 10 x 0.7 = 7.000000000000001 rounds up as it does there)."""
    return max(int(-(-n_tok * cfg.top_k * cfg.capacity_factor // cfg.num_experts)), 1)


class MoEMLP(nn.Module):
    """The router ``(D -> E)`` and the stacked expert weights ``w_gate``,
    ``w_up`` ``(E, D, inter)`` and ``w_down`` ``(E, inter, D)``, kept
    ``(in, out)`` as in the JAX tree."""

    def __init__(self, d: int, cfg: MoEConfig, *, device, dtype):
        super().__init__()
        e, inter = cfg.num_experts, cfg.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.router = empty(nn.Linear, d, e, bias=False, **kw)
        self.w_gate = nn.Parameter(torch.empty(e, d, inter, **kw))
        self.w_up = nn.Parameter(torch.empty(e, d, inter, **kw))
        self.w_down = nn.Parameter(torch.empty(e, inter, d, **kw))

    def reset_parameters(self, gen: torch.Generator, std: float) -> None:
        """The JAX init (``init_moe``): every weight N(0, std^2)."""
        init_normal(gen, std, self.router.weight, self.w_gate, self.w_up, self.w_down)


@dataclasses.dataclass
class Routing:
    """Where the N tokens' k choices go: the router's f32 probabilities
    (N, E), the chosen experts' probabilities and indices (N, k), each
    choice's place in its expert's buffer (N, k), whether it is kept, and
    the capacity."""

    probs: torch.Tensor
    top_p: torch.Tensor
    top_idx: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    cap: int


def route(moe: MoEMLP, xf: torch.Tensor, cfg: MoEConfig, par=None, rows: int = 1
          ) -> Routing:
    """Routing of the rows ``xf`` (N, D) in the compute dtype. The top-k
    is a step function of the logits: a rounding that moves two near-equal
    logits past each other sends the token to another expert. With ``par``
    the capacity and the places are those of the global token set, of which
    ``xf`` is this rank's ``rows`` batch rows."""
    n_tok, e, k = xf.shape[0], cfg.num_experts, cfg.top_k
    # f32 logits of compute-dtype operands: a product of two bf16 values is
    # exact in f32, so only the f32 sum rounds (JAX's preferred_element_type)
    w = moe.router.weight.to(xf.dtype)
    logits = product(F.linear, xf.float(), w.float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_idx = torch.topk(probs, k, dim=-1, sorted=True)
    if par is not None and par.tokens > 1:
        return place(probs, top_p, top_idx, e, capacity(n_tok * par.tokens, cfg),
                     par.global_positions(top_idx, e, rows))
    return place(probs, top_p, top_idx, e, capacity(n_tok, cfg))


def positions(top_idx: torch.Tensor, e: int) -> torch.Tensor:
    """Each choice's place in its expert's buffer (N, k): the choices taken
    choice-major (all first choices, then all second choices, ...), each in
    token order."""
    n_tok, k = top_idx.shape
    onehot = F.one_hot(top_idx, e)                                   # (N, k, E)
    flat = onehot.transpose(0, 1).reshape(k * n_tok, e)              # choice-major
    return ((flat.cumsum(0) - 1) * flat).sum(-1).reshape(k, n_tok).T  # (N, k)


def place(probs: torch.Tensor, top_p: torch.Tensor, top_idx: torch.Tensor, e: int,
          cap: int, pos: torch.Tensor | None = None) -> Routing:
    """The places of the chosen experts ``top_idx`` (N, k) in their
    buffers (``pos``, or :func:`positions`), and which are kept (place
    below ``cap``, nonzero probability)."""
    if pos is None:
        pos = positions(top_idx, e)
    keep = (pos < cap) & (top_p > 0)
    return Routing(probs, top_p, top_idx, pos, keep, cap)


def moe_mlp(moe: MoEMLP, x: torch.Tensor, cfg: MoEConfig, dispatch: str = "scatter"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The routed mixture over ``x`` (B, T, D), in x's dtype (the compute
    dtype: the weights are cast to it, as the JAX function casts them).
    Returns (output (B, T, D), the f32 aux loss). Sharded by ``moe.par``
    when set (the module docstring)."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"dispatch {dispatch!r} is not one of {DISPATCHES}")
    b, t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    n_tok = b * t
    xf = x.reshape(n_tok, d)
    par = getattr(moe, "par", None)
    r = route(moe, xf, cfg, par, rows=b)
    if par is not None and par.tokens > 1:
        # this rank's rows only (the module docstring): local places
        pos, cap = positions(r.top_idx, e), min(r.cap, n_tok)
    else:
        pos, cap = r.pos, r.cap
    gates = r.top_p / r.top_p.sum(-1, keepdim=True)
    gk = gates.to(x.dtype) * r.keep.to(x.dtype)                      # (N, k)

    if dispatch == "scatter":
        slot = torch.where(r.keep, r.top_idx * cap + pos, e * cap).reshape(-1)
        rows = xf[:, None].expand(n_tok, k, d).reshape(n_tok * k, d)
        buf = xf.new_zeros(e * cap + 1, d).index_copy(0, slot, rows)
        buf = buf[: e * cap].reshape(e, cap, d)
    else:
        # (N, k, E, C): 1 where choice (n, k) lands in slot (e, c)
        ek = (F.one_hot(r.top_idx, e).to(x.dtype)[..., None]
              * F.one_hot(torch.where(r.keep, pos, cap), cap + 1)
              .to(x.dtype)[..., :cap][:, :, None, :])
        buf = torch.einsum("nec,nd->ecd", ek.sum(1), xf)            # (E, C, D)

    wg, wu, wd = (w.to(x.dtype) for w in (moe.w_gate, moe.w_up, moe.w_down))
    if par is not None and par.ep_size > 1:
        buf = par.experts_rows(buf)                   # this rank's experts
    gate = torch.bmm(buf, wg)
    up = torch.bmm(buf, wu)
    h = F.silu(gate.float()).to(up.dtype) * up
    out_buf = torch.bmm(h, wd)                        # (E, C, D)
    if par is not None and par.ep_size > 1:
        out_buf = par.gather_experts(out_buf)

    if dispatch == "scatter":
        # each choice's expert row; a dropped choice reads the zero row
        table = torch.cat([out_buf.reshape(e * cap, d), out_buf.new_zeros(1, d)])
        out = (table[slot].reshape(n_tok, k, d) * gk[..., None]).sum(1)
    else:
        combine = (gk[..., None, None] * ek).sum(1)                  # (N, E, C)
        out = torch.einsum("nec,ecd->nd", combine, out_buf)

    if par is not None and par.tokens > 1:
        frac_tokens, frac_probs = par.global_means(F.one_hot(r.top_idx[:, 0], e).float(),
                                                   r.probs)
    else:
        frac_tokens = F.one_hot(r.top_idx[:, 0], e).float().mean(0)
        frac_probs = r.probs.mean(0)
    aux = e * (frac_tokens * frac_probs).sum()
    return out.reshape(b, t, d), aux

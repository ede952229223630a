"""Checkpoint save and resume (counterpart of ``aki_tpu/train/checkpoints.py``,
stored with ``torch.save`` in the reference's own layout).

- a checkpoint is one file, ``checkpoint_{epoch}_{step}.pt``, under the run
  directory; ``latest`` is the newest by step, then epoch;
- the model weights sit under ``model_state_dict`` with the reference key
  names, so the JAX package's importer
  (``aki_tpu/convert/cli.py:load_torch_state_dict``) reads a port
  checkpoint as it stands; the optimizer state, ``step`` and ``epoch`` sit
  beside them;
- the frozen vision tower (``vision_encoder.*``) is left out unless
  ``include_frozen``;
- ``keep_last`` deletes all but the newest ``keep_last`` after a save;
- restore is lenient: a key missing from the file, or one whose shape
  differs, keeps the live (init) value; an optimizer state of other
  groups (or none, a weights-only file) keeps the fresh one, and one that
  fits is loaded or the restore raises.

A sharded model saves the same file: every rank gathers each sharded
parameter and moment (a collective; expert blocks over the expert ranks,
a pipeline stage's layers to the first stage), rank 0 (``is_main``)
writes, the moments indexed in the whole model's optimizer order. Every
rank reads the file and keeps its own shards, so a run dir written at one
mesh restores at another (fsdp=2 to one device and back).
"""

from __future__ import annotations

import re
from pathlib import Path

import torch
import torch.distributed as dist

from .optim import is_frozen_path, local
from .step import TrainState

_NAME = re.compile(r"checkpoint_(\d+)(?:_(\d+))?\.pt")


class CheckpointManager:
    def __init__(self, run_dir: str, keep_last: int | None = None, is_main: bool = True):
        self.path = Path(run_dir).absolute()
        if is_main:
            self.path.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.is_main = is_main

    def list_checkpoints(self) -> list[tuple[int, int, Path]]:
        """[(epoch, step, path)] sorted by (step, epoch)."""
        out = []
        for p in self.path.glob("checkpoint_*.pt"):
            m = _NAME.fullmatch(p.name)
            if m:
                out.append((int(m.group(1)), int(m.group(2) or 0), p))
        return sorted(out, key=lambda t: (t[1], t[0]))

    def latest(self) -> Path | None:
        cks = self.list_checkpoints()
        return cks[-1][2] if cks else None

    def save(self, state: TrainState, epoch: int, step: int | None = None,
             include_frozen: bool = False) -> Path:
        step = state.step if step is None else step
        shards = getattr(state.model, "expert_shards", None)
        pipe = stage_of(state.model)
        # every rank gathers (a collective); the writer, and a pipeline
        # stage sending its layers to it, keep a host copy
        keep = self.is_main or pipe is not None
        host = lambda t: t.detach().cpu() if keep else None  # noqa: E731
        weights = {k: host(whole(v, shards, k)) for k, v in state.model.state_dict().items()
                   if include_frozen or not is_frozen_path(k)}
        names = {id(p): n for n, p in state.model.named_parameters()}
        params = state.optimizer.params
        opt = state.optimizer.state_dict()
        moments = {names[id(params[i])]: {
            k: host(whole(v, shards, names[id(params[i])], v.dim() > 0))
            if isinstance(v, torch.Tensor) else v for k, v in st.items()}
            for i, st in sorted(opt["adamw"]["state"].items())}
        groups = full_order(state)
        if pipe is not None:
            # the stages' layers (and their moments) to the pipe's first stage
            weights, moments = (merge_stages(x, pipe) for x in (weights, moments))
        flat = [n for g in groups for n in g]
        offsets = [sum(len(g) for g in groups[:i]) for i in range(len(groups))]
        adamw = {"state": {i: moments[n] for i, n in enumerate(flat) if n in moments},
                 "param_groups": [{**g, "params": list(range(o, o + len(names_)))}
                                  for g, o, names_ in zip(opt["adamw"]["param_groups"],
                                                          offsets, groups)]}
        return self._write(epoch, step, {"model_state_dict": weights,
                                         "optimizer_state_dict": {**opt, "adamw": adamw},
                                         "step": int(state.step), "epoch": int(epoch)})

    def save_weights(self, weights: dict[str, torch.Tensor], epoch: int, step: int) -> Path:
        """A checkpoint of ``weights`` alone (an import): a restore keeps the
        fresh optimizer state."""
        return self._write(epoch, step, {"model_state_dict": weights, "step": int(step),
                                         "epoch": int(epoch)})

    def _write(self, epoch: int, step: int, payload: dict) -> Path:
        target = self.path / f"checkpoint_{epoch}_{step}.pt"
        if self.is_main:
            tmp = target.with_suffix(".tmp")
            torch.save(payload, tmp)
            tmp.replace(target)
            self._gc(keep=target)
        if dist.is_initialized():
            dist.barrier()   # no rank reads the run dir before the write ends
        return target

    def _gc(self, keep: Path) -> None:
        if self.keep_last is None:
            return
        older = [p for *_, p in self.list_checkpoints() if p != keep]
        for p in older[: max(0, len(older) - (self.keep_last - 1))]:
            p.unlink(missing_ok=True)

    def restore(self, state: TrainState, path: Path | None = None) -> tuple[TrainState, int]:
        """Load ``path`` (default: the newest) into ``state`` in place;
        returns (state, epoch). Without a checkpoint, (state, 0)."""
        path = path or self.latest()
        if path is None:
            return state, 0
        # memory-mapped: the ranks of a host share one copy in the page cache
        blob = torch.load(path, map_location="cpu", weights_only=False, mmap=True)
        load_weights(state.model, blob["model_state_dict"])
        groups = full_order(state)                  # a collective under a pipe
        opt = blob.get("optimizer_state_dict")
        if opt is not None and fits(opt, groups):
            index = {n: i for i, n in enumerate(n for g in groups for n in g)}
            params = state.optimizer.params
            shards = getattr(state.model, "expert_shards", None)
            names = {id(p): n for n, p in state.model.named_parameters()}
            saved = opt["adamw"]["state"]
            adamw = {**state.optimizer.state_dict()["adamw"], "state": {
                i: {k: moment_like(v, p, names[id(p)], shards)
                    if isinstance(v, torch.Tensor) and v.dim() else v
                    for k, v in saved[index[names[id(p)]]].items()}
                for i, p in enumerate(params) if index[names[id(p)]] in saved}}
            state.optimizer.load_state_dict({**opt, "adamw": adamw})
        # else the optimizer changed since the save: keep the fresh state
        state.step = int(blob["step"])
        return state, int(blob["epoch"])


def fits(opt: dict, groups: list[list[str]]) -> bool:
    """Whether a saved optimizer state is this optimizer's: the same
    groups, of the same sizes (what ``torch.optim`` itself checks). A state
    that fits is loaded, and an error in loading it is raised."""
    try:
        saved = [len(g["params"]) for g in opt["adamw"]["param_groups"]]
        return "count" in opt and "state" in opt["adamw"] \
            and saved == [len(g) for g in groups]
    except (KeyError, TypeError):
        return False


def load_weights(model: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``model``'s tensors in place (cast to their
    dtype and device), leniently: a key the model lacks, or one whose shape
    differs, is skipped and the live value kept."""
    live = model.state_dict()
    shards = getattr(model, "expert_shards", None)
    with torch.no_grad():
        for k, v in weights.items():
            v = block(v, shards, k)
            if k in live and live[k].shape == v.shape:
                local(live[k]).copy_(local(shard_like(v, live[k])))


def stage_of(model):
    """The model's pipeline stage, or None."""
    return getattr(model.lang_model.model, "pipe", None)


def full_order(state: TrainState) -> list[list[str]]:
    """The names of the optimizer's parameters, group by group, in the
    order of the whole model's optimizer (the file's indices). A pipeline
    stage holds its own layers only: the stages' layer names are put in
    stage order between the names they share (a collective over the pipe)."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    groups = [[names[id(p)] for p in g["params"]]
              for g in state.optimizer.opt.param_groups]
    pipe = stage_of(state.model)
    if pipe is None:
        return groups
    stages = [None] * pipe.size
    dist.all_gather_object(stages, groups, group=pipe.group)
    layer = lambda n: n.startswith("lang_model.model.layers.")  # noqa: E731
    out = []
    for gi, first in enumerate(stages[0]):
        at = [i for i, n in enumerate(first) if layer(n)]
        lo, hi = (at[0], at[-1] + 1) if at else (len(first), len(first))
        out.append(first[:lo] + [n for st in stages for n in st[gi] if layer(n)] + first[hi:])
    return out


def merge_stages(local: dict, pipe) -> dict:
    """The stages' dicts merged on the pipe's first stage (the names they
    share hold the same values); ``local`` elsewhere, where nothing is
    written. A collective over the pipe."""
    parts = [None] * pipe.size if pipe.rank == 0 else None
    dist.gather_object(local, parts, dst=pipe.peer(0), group=pipe.group)
    if pipe.rank != 0:
        return local
    out = {}
    for part in parts:
        for k, v in part.items():
            out.setdefault(k, v)
    return out


def whole(t: torch.Tensor, shards, name: str, gather: bool = True) -> torch.Tensor:
    """A parameter (or moment) of ``name`` whole: gathered over its shards
    (collective), and over the expert ranks for an expert weight's block."""
    t = full_tensor(t)
    if gather and shards is not None and name in shards.names:
        t = shards.gather(t)
    return t


def block(full: torch.Tensor, shards, name: str) -> torch.Tensor:
    """This rank's expert block of a whole expert weight; other tensors as
    they are."""
    if shards is not None and name in shards.names:
        return shards.local(full)
    return full


def moment_like(full: torch.Tensor, live: torch.Tensor, name: str, shards) -> torch.Tensor:
    """A saved moment of the parameter ``name`` laid out as the parameter
    ``live`` (its expert block, its shard); a moment of another shape than
    the parameter raises."""
    full = block(full, shards, name)
    if full.shape != live.shape:
        raise ValueError(f"checkpoint: a moment of {name} is {tuple(full.shape)}, the "
                         f"parameter {tuple(live.shape)}")
    return shard_like(full, live)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (a collective: every rank calls it); a
    tensor itself."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def shard_like(full: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """``full`` laid out as ``live``: this rank's shard when ``live`` is a
    DTensor (cut locally from the whole tensor every rank read), else
    ``full`` itself."""
    if not hasattr(live, "device_mesh"):
        return full
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full.to(device=live.device, dtype=live.dtype),
                             live.device_mesh, live.placements, src_data_rank=None)

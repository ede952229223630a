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
  differs, keeps the live (init) value; an optimizer state that does not
  fit keeps the fresh one.
"""

from __future__ import annotations

import re
from pathlib import Path

import torch

from .optim import is_frozen_path
from .step import TrainState

_NAME = re.compile(r"checkpoint_(\d+)(?:_(\d+))?\.pt")


class CheckpointManager:
    def __init__(self, run_dir: str, keep_last: int | None = None):
        self.path = Path(run_dir).absolute()
        self.path.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last

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
        weights = {k: v.detach().cpu() for k, v in state.model.state_dict().items()
                   if include_frozen or not is_frozen_path(k)}
        return self._write(epoch, step, {"model_state_dict": weights,
                                         "optimizer_state_dict": state.optimizer.state_dict(),
                                         "step": int(state.step), "epoch": int(epoch)})

    def save_weights(self, weights: dict[str, torch.Tensor], epoch: int, step: int) -> Path:
        """A checkpoint of ``weights`` alone (an import): a restore keeps the
        fresh optimizer state."""
        return self._write(epoch, step, {"model_state_dict": weights, "step": int(step),
                                         "epoch": int(epoch)})

    def _write(self, epoch: int, step: int, payload: dict) -> Path:
        target = self.path / f"checkpoint_{epoch}_{step}.pt"
        tmp = target.with_suffix(".tmp")
        torch.save(payload, tmp)
        tmp.replace(target)
        self._gc(keep=target)
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
        blob = torch.load(path, map_location="cpu", weights_only=False)
        load_weights(state.model, blob["model_state_dict"])
        try:
            state.optimizer.load_state_dict(blob["optimizer_state_dict"])
        except (KeyError, ValueError):
            pass   # the optimizer changed since the save: keep the fresh state
        state.step = int(blob["step"])
        return state, int(blob["epoch"])


def load_weights(model: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``model``'s tensors in place (cast to their
    dtype and device), leniently: a key the model lacks, or one whose shape
    differs, is skipped and the live value kept."""
    live = model.state_dict()
    with torch.no_grad():
        for k, v in weights.items():
            if k in live and live[k].shape == v.shape:
                live[k].copy_(v)

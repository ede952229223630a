"""Training metrics: JSONL, TensorBoard when it imports, and step timers
(counterpart of ``aki_tpu/train/metrics.py``; its profiler hook is the
trace spans of :mod:`aki_torch.trace` here)."""

from __future__ import annotations

import json
import time
from pathlib import Path


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.sum = self.count = 0.0
        self.avg = 0.0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class MetricsLogger:
    """Appends one JSON record per :meth:`log` to ``run_dir/metrics.jsonl``
    and, when ``torch.utils.tensorboard`` imports, writes the same scalars
    under ``run_dir/tb``. ``last`` is the newest record."""

    def __init__(self, run_dir: str, use_tensorboard: bool = True):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = (self.run_dir / "metrics.jsonl").open("a")
        self._tb = None
        self.last: dict | None = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=str(self.run_dir / "tb"))
            except Exception:  # noqa: BLE001 — TensorBoard is optional
                self._tb = None

    def log(self, step: int, **scalars):
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            rec[k] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(k, float(v), int(step))
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        self.last = rec

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

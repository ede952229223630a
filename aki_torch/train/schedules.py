"""Learning-rate schedules: warmup, then cosine to ``min_lr``, linear to 0,
or constant (counterpart of ``aki_tpu/train/schedules.py``, with optax's
values: ``linear_schedule``, ``cosine_decay_schedule``, ``join_schedules``).

Each is a plain function of the update count n (0 for the first update):
with ``warmup_steps > 0`` the first update's rate is 0, as in optax.
"""

from __future__ import annotations

import math
from collections.abc import Callable

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    def schedule(n):
        frac = 1.0 - min(max(n, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def _cosine(init: float, steps: int, alpha: float) -> Schedule:
    def schedule(n):
        cos = 0.5 * (1.0 + math.cos(math.pi * min(n, steps) / steps))
        return init * ((1.0 - alpha) * cos + alpha)
    return schedule


def _join(warmup: Schedule, after: Schedule, boundary: int) -> Schedule:
    return lambda n: warmup(n) if n < boundary else after(n - boundary)


def cosine_min_lr(peak_lr: float, min_lr: float, warmup_steps: int,
                  total_steps: int) -> Schedule:
    alpha = min_lr / peak_lr if peak_lr > 0 else 0.0
    return _join(_linear(0.0, peak_lr, max(warmup_steps, 1)),
                 _cosine(peak_lr, max(total_steps - warmup_steps, 1), alpha), warmup_steps)


def linear(peak_lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    return _join(_linear(0.0, peak_lr, max(warmup_steps, 1)),
                 _linear(peak_lr, 0.0, max(total_steps - warmup_steps, 1)), warmup_steps)


def constant(peak_lr: float, warmup_steps: int) -> Schedule:
    return _join(_linear(0.0, peak_lr, max(warmup_steps, 1)), lambda n: peak_lr,
                 warmup_steps)


def make_schedule(name: str, peak_lr: float, min_lr: float,
                  warmup_steps: int, total_steps: int) -> Schedule:
    if name == "cosine":
        return cosine_min_lr(peak_lr, min_lr, warmup_steps, total_steps)
    if name == "linear":
        return linear(peak_lr, warmup_steps, total_steps)
    if name == "constant":
        return constant(peak_lr, warmup_steps)
    raise ValueError(f"unknown schedule: {name}")

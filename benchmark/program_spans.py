"""What the per-layer readers of the program's own spans share: the
program's tracer (``aki_torch.trace``), the serving window's answered
requests, the training window's steps, and the mean device-stream time of
profiled spans.

Every reader returns None where the program keeps no such record (a
program without the tracer, a slice that held no such span) or where the
tracer's ring dropped a record the reading needed.
"""

from __future__ import annotations

import statistics


def tracer():
    """The program's tracer, or None where the program has none."""
    try:
        from aki_torch import trace
    except ImportError:
        return None
    return trace.TRACER


def serve_window(ctx: dict) -> tuple[int, int] | None:
    """(first tick's start, last tick's end) of the window's ticks outside
    the profiled slice, in host ns (``time.perf_counter_ns``'s clock)."""
    ticks = ctx.get("ticks")
    if not ticks:
        return None
    return round(min(a for a, _, _ in ticks) * 1e9), round(max(b for _, b, _ in ticks) * 1e9)


def answered(ctx: dict) -> list | None:
    """The request records of the requests answered in the window, less
    those with a stamp taken while tracing was on."""
    tr, win = tracer(), serve_window(ctx)
    if tr is None or win is None or not tr.kept_since(win[0]):
        return None
    lo, hi = win
    return [r for r in tr.requests() if lo <= r.t_done <= hi and not r.profiled] or None


def mean_ms(ns: list[int]) -> float | None:
    return statistics.fmean(ns) / 1e6 if ns else None


def device_ms(spans) -> float | None:
    """Mean device-stream ms of the profiled spans among ``spans`` (their
    CUDA events); None when none holds events."""
    times = [t for t in (s.device_ms() for s in spans if s.profiled) if t is not None]
    return statistics.fmean(times) if times else None


def window_spans(ctx: dict, name: str) -> list | None:
    """The spans ``name`` that opened in the serving window."""
    tr, win = tracer(), serve_window(ctx)
    if tr is None or win is None or not tr.kept_since(win[0]):
        return None
    lo, hi = win
    return [s for s in tr.spans(name) if lo <= s.t0 <= hi]


def train_steps(ctx: dict) -> list | None:
    """The ``train.step`` spans of the window's steps: the last
    ``len(steps) + len(slice_steps)`` of them (the check's steps come
    before); None when the ring lost one of them or of what they hold."""
    tr = tracer()
    n = len(ctx.get("steps") or ()) + len(ctx.get("slice_steps") or ())
    if tr is None or n == 0:
        return None
    steps = tr.spans("train.step")[-n:]
    return steps if len(steps) == n and tr.kept_since(steps[0].t0) else None

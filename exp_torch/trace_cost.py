#!/usr/bin/env python3
"""Host cost of one span of ``aki_torch.trace``: an empty ``with
trace.span(...)`` holding two small attributes, as the serving engine's
decode chunk opens it, timed over many spans.

Usage, from the root of a checkout (CPU or card):

    python3 exp_torch/trace_cost.py [--spans N] [--rounds R]

Prints the microseconds a span, the median and least over the rounds,
with tracing off (the path every span takes) and with ``trace.enable()``
(a ``record_function`` range, and CUDA events where there is a card),
beside an empty loop of the same length. Each span enters the process's
ring, so the ring fills and drops as it would in a long run.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def per_span_us(n: int, body) -> float:
    t0 = time.perf_counter()
    body(n)
    return (time.perf_counter() - t0) / n * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spans", type=int, default=200_000)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    import torch

    from aki_torch import trace

    if torch.cuda.is_available():
        torch.cuda.init()       # so that a profiled span records its CUDA events

    def spans(n):
        for _ in range(n):
            with trace.span("serve.decode_chunk", n=8, live=48):
                pass

    def empty(n):
        for _ in range(n):
            pass

    out = {}
    for label, enabled, body, n in (("empty loop", False, empty, args.spans),
                                    ("off", False, spans, args.spans),
                                    ("enabled", True, spans, args.spans // 10)):
        (trace.enable if enabled else trace.disable)()
        try:
            times = [per_span_us(n, body) for _ in range(args.rounds)]
        finally:
            trace.disable()
        out[label] = times
        print(f"{label:>10}: median {statistics.median(times):.3f} us, least {min(times):.3f} us "
              f"a span ({n} spans x {args.rounds} rounds)")
    where = torch.cuda.get_device_name(0) if torch.cuda.is_initialized() else "cpu"
    print(f"device: {where}; ring dropped {trace.TRACER.dropped}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

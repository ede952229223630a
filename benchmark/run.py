"""Run one cell of the benchmark once and print its result as the last line
of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic and metrics come from ``BENCHMARK.json``
and the files it names. Inputs and weights are made from ``--seed``. With
``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics read from a profiled slice of the
window. The run needs a CUDA card (as many as the cell asks for) and never
falls back to the CPU; it fails, printing no result, when a module of JAX
or of the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()     # set-up counts from here: loading torch is set-up too
ROOT = Path(__file__).resolve().parents[1]


def fixed_caches() -> None:
    """Build and kernel caches at fixed places inside the checkout, so that
    only a checkout's first run builds; set before torch is imported."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    # keep libraries that could load JAX by themselves from doing so
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def run_cell(cell, seed: int, seconds: float, trace: bool, device, **kw) -> tuple[str, dict]:
    """Run ``cell`` (a :class:`harness.Cell`) on ``device`` and return its
    result line and the driver's record."""
    import torch

    from benchmark import harness

    rec = harness.driver(cell.traffic["kind"]).run(cell, seed, seconds, trace, device, **kw)
    dev = harness.device_info(torch, device, cell.chips)
    dev["memory_peak_bytes"] = int(rec["memory_peak_bytes"])
    breakdown = None
    if trace:
        tr = rec["ctx"].get("trace")
        if tr is not None:
            dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
            breakdown = tr["breakdown"]
        metrics = harness.read_per_layer(cell.per_layer, rec["ctx"])
    else:
        metrics = {m["name"]: {"value": rec["e2e"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    line = harness.result_line(rec["correct"], rec["attempted"], rec["failed"], metrics, dev,
                               rec["checks"], breakdown)
    return line, rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fixed_caches()
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    cell = harness.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line, rec = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                         t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}: JAX or the JAX package", file=sys.stderr)
        return 3
    harness.print_checks(rec["checks"])
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

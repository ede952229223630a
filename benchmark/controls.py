"""Readings for the limits of a cell's check, on the chip at the cell's own
size; the benchmark's own runs never run this.

    python3 benchmark/controls.py --workload <name> --seeds 1,2,3 --seconds 10 \
        [--program] [--control] [--faults] --out <file.jsonl>

For each seed, one JSON line a reading:

- ``--program``: a run of the cell as the benchmark runs it (a short
  window), with every number its check compares: the lower readings;
- ``--control``: the check's control, one precision step down. Serving: the
  program's own W4A8 path (``quantize_params(mode="w4a8")``) in place of
  W8A8, held to the reference of the configuration's own ``serving``
  block (W8A8). Training: the plain reference computed
  in float8 wherever the program holds bf16 (``reference/lowp.py``) in the
  program's place;
- ``--faults``: the faults the cell can have, planted in the reference put
  in the program's place (training: half of each batch left out; a state
  left unchanged reads 1 and needs no run) or in the served answers
  (serving: one served token altered).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def emit(out, **rec) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    with open(out, "a") as f:
        f.write(line + "\n")


def serving(cell, seeds, seconds, args, device) -> None:
    import numpy as np

    from benchmark import harness

    drv = harness.driver(cell.traffic["kind"])
    for seed in seeds:
        if args.program or args.faults:
            t0 = time.perf_counter()
            rec = drv.run(cell, seed, seconds, False, device)
            emit(args.out, seed=seed, kind="program", checks=rec["checks"], e2e=rec["e2e"],
                 gap_at=rec["gap_at"], seconds=time.perf_counter() - t0)
            if args.faults:
                sample = [list(s) for s in rec["sample"]]
                rng = np.random.RandomState(seed % 2**32)
                r = int(rng.randint(len(sample)))
                toks = list(sample[r][2])
                k = int(rng.randint(len(toks)))
                toks[k] = int(rng.randint(5, cell.config["model"]["initial_tokenizer_len"]))
                sample[r][2] = toks
                gap, where = drv.served_gap(cell.config, seed, sample, device)
                emit(args.out, seed=seed, kind="fault_token_altered",
                     checks={"served_gap_std": gap}, where=where)
        if args.control:
            t0 = time.perf_counter()
            rec = drv.run(cell, seed, seconds, False, device, control="w4a8")
            emit(args.out, seed=seed, kind="control_w4a8", checks=rec["checks"], e2e=rec["e2e"],
                 gap_at=rec["gap_at"], seconds=time.perf_counter() - t0)


def training(cell, seeds, seconds, args, device) -> None:
    import torch

    from benchmark import harness
    from benchmark.reference.lowp import fp8_product, fp8_store

    drv = harness.driver(cell.traffic["kind"])
    steady = cell.traffic["check"]["steady_leaf"]
    for seed in seeds:
        if args.program:
            t0 = time.perf_counter()
            rec = drv.run(cell, seed, seconds, False, device)
            emit(args.out, seed=seed, kind="program", checks=rec["checks"], e2e=rec["e2e"],
                 seconds=time.perf_counter() - t0)
        if not (args.control or args.faults):
            continue
        feed = drv.Feed(cell.traffic, cell.config, seed, device)
        kept = [drv.on_device(feed.batches(i), device) for i in range(cell.traffic["check_steps"])]
        t0 = time.perf_counter()
        want = drv.reference_readings(cell, seed, kept, device)
        emit(args.out, seed=seed, kind="reference", losses=want["losses"],
             seconds=time.perf_counter() - t0)
        runs = []
        if args.control:
            runs.append(("control_fp8", dict(product_of=fp8_product, store=fp8_store)))
        if args.faults:
            runs.append(("fault_half_batch", dict(half=True)))
        for kind, kw in runs:
            t0 = time.perf_counter()
            got = drv.reference_readings(cell, seed, kept, device, **kw)
            emit(args.out, seed=seed, kind=kind, checks=drv.readings_of(got, want, steady),
                 losses=got["losses"], seconds=time.perf_counter() - t0)
        del kept
        torch.cuda.empty_cache() if device.type == "cuda" else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.run import fixed_caches

    fixed_caches()
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("controls: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    dev = torch.device("cuda", 0)
    (serving if cell.traffic["kind"].startswith("serve") else training)(
        cell, seeds, args.seconds, args, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())

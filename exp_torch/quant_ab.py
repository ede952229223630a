#!/usr/bin/env python3
"""Time builds of the fused "op + int8 quantize" kernels (aki_torch/csrc/
fused_quant.cu, K5: rms, ln, silu*mul, gelu) side by side on one GPU, at
chip_smoke.py's phase-9 timed shapes: the W8A8 serving prefill (48 rows of
655 decoder tokens, 48 images of 729 patches) and the one-request prefills.

Usage, from the root of a checkout, on a machine with one H100:

    python3 exp_torch/quant_ab.py [--rounds N] [--out FILE] SOURCE [SOURCE ...]

Each SOURCE is a fused_quant.cu with the C entry fused_quant of this
checkout's signature, for example the parent commit's, written with
`git show HEAD~:aki_torch/csrc/fused_quant.cu` into the git-ignored build/
(a source that includes a header finds it beside itself: copy
aki_torch/csrc/*.cuh there too). Each is built with the checkout's nvcc
flags into build/quant_ab/ and its ptxas report printed. Each build is held
to the plain versions on every shape (the gates of chip_smoke.py phase 9:
QUANT_STEP_MAX, QUANT_SCALE_RTOL); then ``rounds`` rounds time every build
through this checkout's wrappers, in A B ... B A order, by the device time
of the kernels named fused_quant from torch.profiler over 10 calls
(chip_smoke.kernel_split_ms), warm and cold (a 64 MB write before each
call, chip_smoke.cold_split_ms).

Prints per build and shape the median, least and largest over the rounds;
writes the records as one JSON object to FILE (default
build/quant_ab/quant_ab.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from exp_torch.decode_ab import build  # noqa: E402


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_quant.argtypes = [i, p, p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
    lib.fused_quant.restype = i
    lib.fused_quant_error_string.argtypes = [i]
    lib.fused_quant_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "quant_ab", "quant_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("quant_ab: no CUDA device", flush=True)
        return 1
    card = cs.card_line()
    print(card, flush=True)
    from aki_torch.models.configs import aki_4b
    from aki_torch.ops import fused_quant as fq

    libs = [bind(lib) for lib in build(args.sources, os.path.join(ROOT, "build", "quant_ab"))]
    gen = torch.Generator(device="cuda").manual_seed(11)
    records: dict = {"card": card, "sources": args.sources, "gates": [], "rounds": [],
                     "bounds": {}}
    shapes = cs.quant_timing_shapes(aki_4b())
    order = list(range(len(libs))) + list(reversed(range(len(libs))))
    for op, rows, d in shapes:
        key = f"{op}|{rows}x{d}"
        fn, ref = cs.fused_quant_fns(op)
        inputs = cs.fused_quant_inputs(op, rows, d, gen, edge=True)
        want = ref(*inputs)
        records["bounds"][key] = cs.fused_quant_bound(op, rows, d)
        for src, lib in zip(args.sources, libs):
            fq._lib = lib
            got = fn(*inputs)
            torch.cuda.synchronize()
            dq = (got[0].int() - want[0].int()).abs()
            srel = ((got[1] - want[1]).abs() / want[1]).max().item()
            ok = dq.max().item() <= cs.QUANT_STEP_MAX and srel <= cs.QUANT_SCALE_RTOL
            gate = dict(source=src, shape=key, ok=ok, max_abs_err=dq.max().item(),
                        frac_one_step=(dq > 0).float().mean().item(), scale_max_rel_err=srel)
            records["gates"].append(gate)
            print(f"{src} {key}: gates {'ok' if ok else 'FAILED'} {gate}", flush=True)
            if not ok:
                raise SystemExit(f"quant_ab: {src} disagrees with the plain version on {key}")
        del want
        for rnd in range(args.rounds):
            if len(records["rounds"]) <= rnd:
                records["rounds"].append({})
            for i in order:
                fq._lib = libs[i]
                call = lambda: fn(*inputs)  # noqa: E731
                records["rounds"][rnd].setdefault(f"{args.sources[i]}|{key}", []).append(dict(
                    warm=cs.kernel_ms(cs.kernel_split_ms(call), "fused_quant"),
                    cold=cs.kernel_ms(cs.cold_split_ms(call), "fused_quant")))
        records["rounds"][-1][f"clock|{key}"] = cs.sm_clock()
        del inputs
        cs.free_cuda()

    summary = {}
    for key in records["rounds"][0]:
        if key.startswith("clock|"):
            continue
        summary[key] = {}
        for kind in ("warm", "cold"):
            xs = [x[kind] for r in records["rounds"] for x in r[key] if x[kind] is not None]
            if xs:
                summary[key][kind] = dict(median=statistics.median(xs), least=min(xs),
                                          most=max(xs))
                print(f"{key} {kind}: median {statistics.median(xs):.6f} least {min(xs):.6f} "
                      f"most {max(xs):.6f}", flush=True)
    records["summary"] = summary
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(records, fh, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

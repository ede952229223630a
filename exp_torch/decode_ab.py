#!/usr/bin/env python3
"""Time builds of the int8-KV decode attention kernel (aki_torch/csrc/
decode_attention.cu, K4) side by side on one GPU, at chip_smoke.py's phase-10
shapes: the serving cache (32 layers, 48 rows of 704 slots, 32 heads x 96)
with every row at 704 keys and with ragged lengths, and one row of the two
one-request caches (1024 and 1280 slots) at the last decode step's length.

Usage, from the root of a checkout, on a machine with one H100:

    python3 exp_torch/decode_ab.py [--rounds N] [--clusters 1,2,4,8] [--rows 40,48,56]
                                   [--out FILE] SOURCE ...

Each SOURCE is a decode_attention.cu, for example the parent commit's,
written with `git show HEAD~:aki_torch/csrc/decode_attention.cu` into the
git-ignored build/ (a source that includes a header finds it beside itself:
copy aki_torch/csrc/*.cuh there too). Each is built with the checkout's
nvcc flags (aki_torch.ops.cuda_build) into build/decode_ab/ and its ptxas
report printed. A source that exports decode_attention_smem_bytes takes
the cluster size the checkout's wrapper picks (decode_attention.
cluster_size), and with --clusters also each of the sizes listed (a
variant SOURCE@C of its own); one without it has the earlier signature.
Each build is
held to the plain version on every case (chip_smoke.decode_gates); then
``rounds`` rounds time every build, in A B ... B A order, by the device
time of the kernels named decode_attention from torch.profiler over 10
calls (chip_smoke.kernel_split_ms): warm (one layer again and again),
layers (the 32 layers in turn, as a decode step reads them) and cold (a
64 MB write before each call, chip_smoke.cold_split_ms).

--rows times a sweep instead of the cases (after their gates): a 64-row
serving cache with every row at 704 keys, read at each live row count listed (the wrapper's ``live_width``: 32
blocks a row at cluster size 1), device ms over the layers in turn, to
show how the time follows the number of blocks.

Prints per build, case and timing the median, least and largest over the
rounds; writes the records as one JSON object to FILE (default
build/decode_ab/decode_ab.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def build(sources: list[str], out_dir: str) -> list[ctypes.CDLL]:
    """One nvcc per source, all started together; prints each ptxas report
    and returns the loaded libraries."""
    from aki_torch.ops import cuda_build

    os.makedirs(out_dir, exist_ok=True)

    def one(item):
        i, src = item
        out = os.path.join(out_dir, f"lib{i}.so")
        proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", out, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode:
            raise SystemExit(f"ab: nvcc failed for {src}:\n{proc.stdout}")
        return out, proc.stdout

    with ThreadPoolExecutor(len(sources)) as ex:
        built = list(ex.map(one, enumerate(sources)))
    libs = []
    for src, (path, report) in zip(sources, built):
        cs.print_ptxas(src, report)
        libs.append(ctypes.CDLL(path))
    return libs


def bind(lib: ctypes.CDLL) -> bool:
    p, i = ctypes.c_void_p, ctypes.c_int
    clustered = hasattr(lib, "decode_attention_smem_bytes")
    lib.decode_attention.argtypes = ([p] * 7 + [i] * 8 + [ctypes.c_float]
                                     + ([i] if clustered else []) + [p])
    lib.decode_attention.restype = i
    lib.decode_attention_error_string.argtypes = [i]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return clustered


def caller(lib, clustered, case, layer_of, cluster=None, rows=None):
    """A function of no arguments that launches ``lib``'s kernel once on
    ``case``'s cache at layer ``layer_of()`` into a fresh output, for its
    first ``rows`` rows (all when None), with ``cluster`` blocks per (head,
    row) (the wrapper's pick when None)."""
    from aki_torch.ops import decode_attention as da

    q, k, ks, v, vs, lens = case["tensors"]
    n_layers, b, s_len, hkv = ks.shape
    h, d = q.shape[2], q.shape[3]
    rows = b if rows is None else rows
    if cluster is None:
        cluster = da.cluster_size(rows * h, da._sm_count(q.device), s_len, d)

    def call():
        out = torch.empty_like(q)
        args = [q.data_ptr(), k.data_ptr(), ks.data_ptr(), v.data_ptr(), vs.data_ptr(),
                lens.data_ptr(), out.data_ptr(), layer_of(), n_layers, b, rows, s_len, h, hkv,
                d, ctypes.c_float(d ** -0.5)]
        args += [cluster] if clustered else []
        rc = lib.decode_attention(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit("ab: launch failed: " + lib.decode_attention_error_string(rc).decode())
        return out

    return call, cluster


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--clusters", default="", help="cluster sizes to force, e.g. 1,2,4,8")
    ap.add_argument("--rows", default="", help="live row counts of a 64-row cache, e.g. 40,48")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "decode_ab", "decode_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device", flush=True)
        return 1
    card = cs.card_line()
    print(card, flush=True)
    libs = build(args.sources, os.path.join(ROOT, "build", "decode_ab"))
    clustered = [bind(lib) for lib in libs]
    from aki_torch.models.configs import aki_4b

    gen = torch.Generator(device="cuda").manual_seed(10)
    cases = cs.decode_timing_cases(gen, [(r["max_len"], r["t_full"] + cs.NEW_TOKENS)
                                         for r in cs.request_prompts(aki_4b())])
    records: dict = {"card": card, "sources": args.sources, "gates": [], "rounds": []}
    forced = [int(c) for c in args.clusters.split(",") if c]
    # (label, library index, forced cluster size or None)
    variants = [(src, i, None) for i, src in enumerate(args.sources)]
    variants += [(f"{src}@C{c}", i, c) for i, src in enumerate(args.sources) if clustered[i]
                 for c in forced]
    for case in cases:
        name = case["name"]
        want = case["plain"]
        for label, i, forced_c in variants:
            fn, cluster = caller(libs[i], clustered[i], case, lambda: case["layer"], forced_c)
            got = fn()
            torch.cuda.synchronize()
            gate = cs.decode_gates(got, want, case["f32"], case["tensors"][5], None)
            cluster = cluster if clustered[i] else None
            records["gates"].append({"source": label, "case": name, "cluster": cluster, **gate})
            print(f"{label} {name}: cluster {cluster} gates "
                  f"{'ok' if gate['ok'] else 'FAILED'} {gate}", flush=True)
            if not gate["ok"]:
                raise SystemExit(f"decode_ab: {label} disagrees with the plain version on {name}")
        del case["plain"], case["f32"]

    sweep = [int(r) for r in args.rows.split(",") if r]
    order = variants + variants[::-1]
    for _ in range(args.rounds):
        rnd: dict = {}
        for case in [] if sweep else cases:
            n_layers = case["tensors"][2].shape[0]
            for label, i, forced_c in order:
                turn = iter(range(1 << 30))
                fixed, _ = caller(libs[i], clustered[i], case, lambda: case["layer"], forced_c)
                cycling, _ = caller(libs[i], clustered[i], case,
                                    lambda: next(turn) % n_layers, forced_c)
                rnd.setdefault(f"{label}|{case['name']}", []).append(dict(
                    warm=cs.kernel_ms(cs.kernel_split_ms(fixed), "decode_attention"),
                    layers=cs.kernel_ms(cs.kernel_split_ms(cycling), "decode_attention"),
                    cold=cs.kernel_ms(cs.cold_split_ms(fixed), "decode_attention")))
        rnd["clock"] = cs.sm_clock()
        records["rounds"].append(rnd)

    if sweep:
        ph = aki_4b().phi3
        q, k, ks, v, vs = cs.decode_inputs(ph.num_layers, 64, cs.SERVE_MAX_LEN, ph.num_heads,
                                           ph.num_kv_heads, ph.head_dim, gen)
        lens = torch.full((64,), cs.SERVE_MAX_LEN, device="cuda", dtype=torch.int32)
        case = dict(tensors=(q, k, ks, v, vs, lens))
        n_layers = ph.num_layers
        for rnd in records["rounds"]:
            for i in range(len(libs)):
                for rows in sweep:
                    turn = iter(range(1 << 30))
                    fn, _ = caller(libs[i], clustered[i], case, lambda: next(turn) % n_layers,
                                   rows=rows)
                    rnd[f"{args.sources[i]}|rows{rows}"] = [dict(layers=cs.kernel_ms(
                        cs.kernel_split_ms(fn), "decode_attention"), warm=None, cold=None)]

    summary = {}
    for key in records["rounds"][0]:
        if key == "clock":
            continue
        summary[key] = {}
        for kind in ("warm", "layers", "cold"):
            xs = [x[kind] for r in records["rounds"] for x in r[key] if x[kind] is not None]
            if xs:
                summary[key][kind] = dict(median=statistics.median(xs), least=min(xs),
                                          most=max(xs))
                print(f"{key} {kind}: median {statistics.median(xs):.6f} least {min(xs):.6f} "
                      f"most {max(xs):.6f}", flush=True)
    records["summary"] = summary
    records["bounds"] = {c["name"]: c["bound"] for c in cases}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(records, fh, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

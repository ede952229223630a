#!/usr/bin/env python3
"""Time builds of the int8-operand flash forward (aki_torch/csrc/
flash_mma_q8.cu, K7) side by side on one GPU, at the two 48-row shapes of
chip_smoke.py's phase 13: the serving admission (48 x 655, 32 heads x 96,
MMA, ragged) and the tower (48 x 729, 16 x 72, non-causal), beside K1
(this checkout's flash_mma_fwd.cu) on the same bf16 tensors.

Usage, from the root of a checkout, on a machine with one H100:

    python3 exp_torch/q8_ab.py [--rounds N] [--out FILE] SOURCE [SOURCE ...]

Each SOURCE is a flash_mma_q8.cu, for example the parent commit's, unpacked
with `git archive` into the git-ignored build/ (a source that includes
hopper.cuh finds it beside itself). Each is built with the checkout's nvcc
flags (aki_torch.ops.cuda_build) into build/q8_ab/ and its ptxas report
printed. A source that exports flash_mma_q8_plan has this checkout's
signature; one without it has the earlier one (no row stride). At both
shapes every build is held to the plain version (chip_smoke.q8_gates); then ``rounds``
rounds time every build, in A B ... B A order, and K1, by the device time
of the kernel from torch.profiler over 20 calls (chip_smoke.device_ms),
with a 64 MB write before each call (chip_smoke.cold_split_ms), and as a
burst of 20 calls by CUDA events (chip_smoke.burst_ms).

Prints per shape and variant the median, least and largest time over the
rounds; writes the records as one JSON object to FILE (default
chiprun_out/q8_ab.json).
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

KERNEL = "flash_mma_q8_kernel"


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
            raise SystemExit(f"q8_ab: nvcc failed for {src}:\n{proc.stdout}")
        return out, proc.stdout

    with ThreadPoolExecutor(len(sources)) as ex:
        built = list(ex.map(one, enumerate(sources)))
    libs = []
    for src, (path, report) in zip(sources, built):
        cs.print_ptxas(src, report)
        libs.append(ctypes.CDLL(path))
    return libs


def variants(sources, libs):
    """(name, library, whether it takes the row stride)."""
    out = []
    for src, lib in zip(sources, libs):
        p, i = ctypes.c_void_p, ctypes.c_int
        strided = hasattr(lib, "flash_mma_q8_plan")
        lib.flash_mma_q8.argtypes = [p] * 12 + [i] * (8 if strided else 7) + [p]
        out.append((src, lib, strided))
    return out


def launcher(lib, strided, ops, out, mask, causal):
    """A call of one build's entry on fixed quantized operands."""
    from aki_torch.ops.flash_mma_q8 import _padded_rows, row_stride

    q8, sq, k8, sk, v8, sv = ops
    b, t, h, d = q8.shape
    s = k8.shape[1]
    valid, offset, coords, n_img = mask
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream().cuda_stream
    head = (ptr(sq), ptr(sk), ptr(sv), ptr(out), ptr(valid), ptr(offset),
            *(ptr(c) for c in coords), n_img, b, t, s, h, d)
    rows = (q8, k8, v8)
    if strided:
        ld = row_stride(h, d)
        rows = tuple(_padded_rows(x, ld) for x in rows)
        args = (*(ptr(x) for x in rows), *head, ld, int(causal), stream)
    else:
        args = (*(ptr(x) for x in rows), *head, int(causal), stream)

    def call():
        rc = lib.flash_mma_q8(*args)
        if rc != 0:
            raise SystemExit(f"q8_ab: launch failed with code {rc}")
    call.keep = rows, ops, mask   # the tensors the pointers point into
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "q8_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("q8_ab: no CUDA device", flush=True)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from aki_torch.models.configs import aki_4b
    from aki_torch.ops.flash_mma import flash_mma_forward
    from aki_torch.ops.flash_mma_args import kernel_mask_args
    from aki_torch.ops.flash_mma_q8 import quantize_operands

    card = cs.card_line()
    cs.log(card, f"torch {torch.__version__}")
    libs = build(args.sources, os.path.join(ROOT, "build", "q8_ab"))
    builds = variants(args.sources, libs)
    cfg = aki_4b()
    ph, sg = cfg.phi3, cfg.siglip
    n_vis = cfg.perceiver.num_latents
    b, t_adm = cs.SERVE_SLOTS, cs.SERVE_BUCKET + n_vis - 1
    gen = torch.Generator(device="cuda").manual_seed(13)
    shapes = {
        "admission": dict(dims=(b, t_adm, t_adm, ph.num_heads, ph.num_heads, ph.head_dim),
                          rects=[(1, 1 + n_vis, 40 + n_vis)], lens=cs.serving_lengths(cfg),
                          causal=True),
        "tower": dict(dims=(b, sg.num_patches, sg.num_patches, sg.num_heads, sg.num_heads,
                            sg.head_dim), rects=None, lens=None, causal=False),
    }
    record = {"card": card, "sources": args.sources, "rounds": args.rounds, "cases": {}}
    for shape, c in shapes.items():
        bb, t, s, h, _, d = c["dims"]
        q, k, v, spec = cs.case_inputs(*c["dims"], gen, c["rects"])
        kv_valid = None if c["lens"] is None else cs.prefix_valid(c["lens"], s)
        kw = dict(spec=spec, kv_valid=kv_valid, q_offset=0, causal=c["causal"])
        ops = quantize_operands(q, k, v, d ** -0.5)
        mask = kernel_mask_args(spec, kv_valid, 0, bb, s, q.device)
        out = torch.empty(q.shape, dtype=torch.bfloat16, device="cuda")
        calls = [launcher(lib, st, ops, out, mask, c["causal"]) for _, lib, st in builds]
        plain = None
        gates = {}
        for (name, _, _), call in zip(builds, calls):
            out.zero_()
            call()
            torch.cuda.synchronize()
            if plain is None:
                from aki_torch.ops.flash_mma_q8 import flash_mma_attention_q8_reference
                plain = flash_mma_attention_q8_reference(q, k, v, **kw).float()
            gates[name] = cs.q8_gates(f"{shape} {name}", out, q, k, v, kw, plain=plain)
        k1 = lambda: flash_mma_forward(q, k, v, spec, kv_valid, 0, c["causal"])  # noqa: E731
        names = [n for n, _, _ in builds]
        runs = {n: [] for n in names + ["K1"]}
        for r in range(args.rounds):
            order = list(range(len(builds)))
            for i in (order if r % 2 == 0 else order[::-1]):
                call = calls[i]
                runs[names[i]].append({
                    "device_ms": cs.device_ms(call, KERNEL),
                    "seen_of": cs.profiler_shortfall(KERNEL),
                    "cold_ms": cs.kernel_ms(cs.cold_split_ms(call), KERNEL),
                    "burst_ms": cs.burst_ms(call), "clock": cs.sm_clock()})
            runs["K1"].append({"device_ms": cs.device_ms(k1, "flash_mma_fwd_kernel"),
                               "cold_ms": cs.kernel_ms(cs.cold_split_ms(k1),
                                                       "flash_mma_fwd_kernel"),
                               "burst_ms": cs.burst_ms(k1), "clock": cs.sm_clock()})
        rec = {"gates": gates, "variants": {}}
        for n in names + ["K1"]:
            summary = {}
            for key in ("device_ms", "cold_ms", "burst_ms"):
                xs = [x[key] for x in runs[n] if x[key] is not None]
                summary[key] = {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}
            rec["variants"][n] = {"summary": summary, "rounds": runs[n]}
            cs.log(f"{shape} {n}: " + " ".join(
                f"{key} median {v['median']:.6f} (min {v['min']:.6f} max {v['max']:.6f})"
                for key, v in summary.items())
                + f" rounds {[round(x['device_ms'] or 0, 6) for x in runs[n]]}")
        record["cases"][shape] = rec
        del q, k, v, ops, calls, out
        cs.free_cuda()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f)
    cs.log(card)
    print(json.dumps({"ok": True, "out": args.out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

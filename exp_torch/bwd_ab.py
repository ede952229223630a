#!/usr/bin/env python3
"""Time builds of the flash backward kernels (aki_torch/csrc/flash_mma_bwd.cu:
dq and dkv) side by side on one GPU, at chip_smoke.py's training shape (2
rows of 655 spliced tokens, 32 heads x 96, MMA mask, row 1 right-padded),
beside SDPA's backward on the same tensors.

Usage, from the root of a checkout, on a machine with one H100:

    python3 exp_torch/bwd_ab.py [--rounds N] [--out FILE] SOURCE [SOURCE ...]

Each SOURCE is a flash_mma_bwd.cu with the C entries flash_mma_bwd_dq and
flash_mma_bwd_dkv of this checkout's signature, for example the parent
commit's, unpacked with `git archive` into the git-ignored build/ (a source
that includes a header finds it beside itself). Each is built with the
checkout's nvcc flags (aki_torch.ops.cuda_build) into build/bwd_ab/, and
its ptxas report (registers, spills) is printed. The forward with lse is
this checkout's. Each build's dq, dk, dv are held to the plain backward
(chip_smoke.gradient_gates); then ``rounds`` rounds time every build
through this checkout's run_backward and SDPA's backward through autograd,
the builds in A B ... B A order. Each timing gives the device time per call
of every kernel by name from torch.profiler over 10 calls
(chip_smoke.kernel_split_ms: the mean of the launches it saw), warm and
with a cold L2 (chip_smoke.cold_split_ms: a 64 MB write before each call),
and the same calls timed as one burst by CUDA events (chip_smoke.burst_ms).

Prints per variant the median, least and largest time over the rounds;
writes the records as one JSON object to FILE (default
build/bwd_ab/bwd_ab.json).
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


def build(sources: list[str]) -> list[ctypes.CDLL]:
    """One nvcc per source, all started together; prints each ptxas report
    and returns the loaded libraries, bound as flash_mma_bwd binds its own."""
    from aki_torch.ops import cuda_build

    out_dir = os.path.join(ROOT, "build", "bwd_ab")
    os.makedirs(out_dir, exist_ok=True)

    def one(item):
        i, src = item
        out = os.path.join(out_dir, f"lib{i}.so")
        proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", out, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode:
            raise SystemExit(f"bwd_ab: nvcc failed for {src}:\n{proc.stdout}")
        return out, proc.stdout

    with ThreadPoolExecutor(len(sources)) as ex:
        built = list(ex.map(one, enumerate(sources)))
    libs = []
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for src, (path, report) in zip(sources, built):
        for line in report.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry",
                                       "Performance Loss")):
                print(f"  ptxas {src}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(path)
        lib.flash_mma_bwd_dq.argtypes = [p] * 12 + [i] * 8 + [f, f, p]
        lib.flash_mma_bwd_dkv.argtypes = [p] * 13 + [i] * 8 + [f, f, p]
        lib.flash_mma_bwd_dq.restype = lib.flash_mma_bwd_dkv.restype = i
        lib.flash_mma_bwd_error_string.argtypes = [i]
        lib.flash_mma_bwd_error_string.restype = ctypes.c_char_p
        libs.append(lib)
    return libs


def training_inputs():
    """The tensors and mask of chip_smoke.py's timed backward case: the
    training batch's spliced length, MMA spec and key validity, q, k, v, dO
    from its seeds, the forward with lse of this checkout."""
    from aki_torch.models.configs import aki_4b
    from aki_torch.ops.flash_mma import flash_mma_forward
    from aki_torch.ops.masks import MMASpec

    cfg = aki_4b()
    ph = cfg.phi3
    batch = cs.train_rows(cfg, torch.Generator().manual_seed(6))
    t, spec, valid = cs.train_spec(cfg, batch)
    spec = MMASpec(*(x.cuda() for x in (spec.img_start, spec.txt_start, spec.txt_end)))
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, h, hkv, d = 2, ph.num_heads, ph.num_kv_heads, ph.head_dim
    q = torch.randn(b, t, h, d, device="cuda", generator=gen).to(torch.bfloat16)
    k = torch.randn(b, t, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn(b, t, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
    do = torch.randn(b, t, h, d, device="cuda", generator=gen).to(torch.bfloat16)
    kw = dict(spec=spec, kv_valid=valid.cuda(), q_offset=0, causal=True)
    out, lse = flash_mma_forward(q, k, v, with_lse=True, **kw)
    return q, k, v, do, out, lse, kw


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "bwd_ab", "bwd_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bwd_ab: no CUDA device", flush=True)
        return 1
    card = cs.card_line()
    print(card, flush=True)
    from aki_torch.ops import flash_mma_bwd as fb
    from aki_torch.ops.attention import attention_mask
    from aki_torch.ops.flash_mma import flash_mma_attention_reference

    libs = build(args.sources)
    q, k, v, do, out, lse, kw = training_inputs()
    b, t, h, d = q.shape
    want = fb.flash_mma_backward_reference(q, k, v, out, do, lse, **kw)
    f32 = [x.float() for x in (q, k, v, do)]
    o32 = flash_mma_attention_reference(*f32[:3], **kw)
    exact = fb.flash_mma_backward_reference(*f32[:3], o32, f32[3],
                                            fb.flash_mma_lse_reference(*f32[:2], **kw), **kw)

    def run_with(lib):
        fb._lib = lib
        return fb.run_backward(q, k, v, out, do, lse, **kw)

    records: dict = {"card": card, "shape": [b, t, t, h, k.shape[2], d],
                     "sources": args.sources, "gates": [], "rounds": []}
    for src, lib in zip(args.sources, libs):
        got = run_with(lib)
        torch.cuda.synchronize()
        errs, ok = cs.gradient_gates(got, want, exact)
        records["gates"].append({"source": src, "ok": ok, **errs})
        print(f"{src}: gates {'ok' if ok else 'FAILED'} {errs}", flush=True)
        if not ok:
            raise SystemExit(f"bwd_ab: {src} disagrees with the plain backward")

    allowed = attention_mask(b, t, t, "cuda", kw["spec"], kw["kv_valid"], 0, True)[:, 0]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                                attn_mask=allowed[:, None])
    do_t = do.transpose(1, 2)
    sdpa = lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), do_t,  # noqa: E731
                                       retain_graph=True)
    order = list(range(len(libs))) + list(reversed(range(len(libs))))
    for _ in range(args.rounds):
        rnd = {}
        for i in order:
            fn = lambda lib=libs[i]: run_with(lib)  # noqa: E731
            warm, cold = cs.kernel_split_ms(fn), cs.cold_split_ms(fn)
            rnd.setdefault(args.sources[i], []).append(dict(
                warm=warm, cold=cold, burst_ms=cs.burst_ms(fn)))
        rnd["sdpa"] = [dict(warm=cs.kernel_split_ms(sdpa), cold=cs.cold_split_ms(sdpa),
                            burst_ms=cs.burst_ms(sdpa))]
        rnd["clock"] = cs.sm_clock()
        records["rounds"].append(rnd)

    def series(name, pick):
        return [pick(x) for r in records["rounds"] for x in r[name]]

    def kernel(split, part):
        return sum(ms for n, ms in split.items() if part is None or part in n)

    summary = {}
    for name in [*args.sources, "sdpa"]:
        rows = {"warm_device_ms": series(name, lambda x: kernel(x["warm"], None)),
                "cold_device_ms": series(name, lambda x: kernel(x["cold"], None)),
                "burst_ms": series(name, lambda x: x["burst_ms"])}
        if name != "sdpa":
            for part in ("flash_mma_dq", "flash_mma_dkv"):
                rows[f"{part}_warm_ms"] = series(name, lambda x: kernel(x["warm"], part))
                rows[f"{part}_cold_ms"] = series(name, lambda x: kernel(x["cold"], part))
        summary[name] = {key: dict(median=statistics.median(xs), least=min(xs), most=max(xs))
                         for key, xs in rows.items()}
        for key, st in summary[name].items():
            print(f"{name} {key}: median {st['median']:.6f} least {st['least']:.6f} "
                  f"most {st['most']:.6f}", flush=True)
    records["summary"] = summary
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(records, fh, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

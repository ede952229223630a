#!/usr/bin/env python3
"""Time builds of the flash forward kernel (aki_torch/csrc/flash_mma_fwd.cu)
side by side on one GPU, at the four 48-row shapes of chip_smoke.py's phase
13: K1 at the tower (48 x 729, 16 heads x 72, non-causal) and at the
serving admission (48 x 655, 32 x 96, MMA, ragged), and K6 (the width-128
entry) on the same tensors in the flat padded-head layout.

Usage, from the root of a checkout, on a machine with one H100:

    python3 exp_torch/fwd_ab.py [--rounds N] [--placements P] [--warm MS,...]
                                [--out FILE] SOURCE [SOURCE ...]

Each SOURCE is a flash_mma_fwd.cu with the C entries flash_mma_fwd and
flash_mma_fwd_flat of this checkout's signature, for example the parent
commit's, unpacked with `git archive` into the git-ignored build/. Each is
built with the checkout's nvcc flags (aki_torch.ops.cuda_build) into
build/fwd_ab/. At every shape each build is held to the plain version
(chip_smoke.forward_gates); then ``rounds`` rounds time every build, this
checkout's wrapper (which marshals the mask and allocates its output at
each call) and SDPA on the same tensors, the builds in A B ... B A order.
Each timing gives the device time per call from torch.profiler over 20
calls (the mean of the launches it saw, and how many; the shortest and
longest launch), the same 20 calls timed as one burst by CUDA events
(chip_smoke.burst_ms), the rate of a fixed GEMM timed just before
(chip_smoke.gemm_witness) and the clocks read just after
(chip_smoke.sm_clock).

Two options separate causes of a spread. ``--placements P`` also runs
every timing on P - 1 copies of the inputs at other addresses (each set
allocated after a spacer): a time that follows where the tensors lie.
``--warm MS,...`` runs each timing after that many ms of GEMMs, one variant
per value: a time that follows what the card ran just before.

Prints per shape and variant the median, least and largest time over the
rounds, the block rows this checkout's library takes and the SM count;
writes the records as one JSON object to FILE (default
chiprun_out/fwd_ab.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def build(sources: list[str]) -> list[ctypes.CDLL]:
    """One nvcc per source, all started together; the loaded libraries."""
    from aki_torch.ops import cuda_build

    out_dir = os.path.join(ROOT, "build", "fwd_ab")
    os.makedirs(out_dir, exist_ok=True)

    def one(item):
        i, src = item
        out = os.path.join(out_dir, f"lib{i}.so")
        proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", out, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode:
            raise SystemExit(f"fwd_ab: nvcc failed for {src}:\n{proc.stdout}")
        return out

    with ThreadPoolExecutor(len(sources)) as ex:
        paths = list(ex.map(one, enumerate(sources)))
    libs = []
    p, i = ctypes.c_void_p, ctypes.c_int
    for path in paths:
        lib = ctypes.CDLL(path)
        lib.flash_mma_fwd.argtypes = [p] * 10 + [i] * 8 + [ctypes.c_float, p]
        lib.flash_mma_fwd_flat.argtypes = [p] * 9 + [i] * 7 + [ctypes.c_float, p]
        libs.append(lib)
    return libs


def launcher(lib, q, k, v, out, mask, causal, scale, heads=None):
    """A call of one build's entry on fixed tensors: flash_mma_fwd on (B, T,
    H, D) tensors, or flash_mma_fwd_flat with ``heads`` on the flat layout."""
    from aki_torch.ops.flash_mma_args import LOG2E

    valid, offset, coords, n_img = mask
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream().cuda_stream
    if heads is None:
        b, t, h, d = q.shape
        s, hkv = k.shape[1], k.shape[2]
        args = (ptr(q), ptr(k), ptr(v), ptr(out), None, ptr(valid), ptr(offset),
                *(ptr(c) for c in coords), n_img, b, t, s, h, hkv, d, int(causal),
                float(scale) * LOG2E, stream)
        entry = lib.flash_mma_fwd
    else:
        b, t, _ = q.shape
        args = (ptr(q), ptr(k), ptr(v), ptr(out), ptr(valid), ptr(offset),
                *(ptr(c) for c in coords), n_img, b, t, k.shape[1], heads, heads, int(causal),
                float(scale) * LOG2E, stream)
        entry = lib.flash_mma_fwd_flat

    def call():
        rc = entry(*args)
        if rc != 0:
            raise SystemExit(f"fwd_ab: launch failed with code {rc}")
    return call


def launch_times(fn, reps: int = 20) -> dict:
    """The forward kernel's device time per call of ``fn`` (as
    chip_smoke.device_ms, torch.profiler over ``reps`` calls after one: the
    mean of the launches it saw, and how many), the shortest and longest
    single launch, with the clocks read after."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    each = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
            if e.device_type == DeviceType.CUDA and "flash_mma_fwd_kernel" in e.name]
    return {"device_ms": sum(each) / len(each), "launches_seen": len(each),
            "launch_min": min(each), "launch_max": max(each), "clock": cs.sm_clock()}


_WARM = []


def warm_up(ms: float) -> None:
    """Keep the card busy with bf16 GEMMs for about ``ms`` ms (none for 0)."""
    if not ms:
        return
    if not _WARM:
        _WARM.append(torch.randn(8192, 8192, device="cuda").to(torch.bfloat16))
    a = _WARM[0]
    t0 = time.perf_counter()
    while (time.perf_counter() - t0) * 1e3 < ms:
        for _ in range(4):
            a @ a
        torch.cuda.synchronize()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--placements", type=int, default=1)
    ap.add_argument("--warm", default="0",
                    help="comma-separated ms of GEMM load before each timing, e.g. 0,300")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "fwd_ab.json"))
    args = ap.parse_args()
    args.warm = [float(w) for w in args.warm.split(",")]
    if not torch.cuda.is_available():
        print("fwd_ab: no CUDA device", flush=True)
        return 1
    from aki_torch.models.configs import aki_4b
    # as chip_smoke.py's main sets them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from aki_torch.ops.flash_mma import (flash_mma_attention, flash_mma_attention_flat,
                                         forward_block_rows)
    from aki_torch.ops.flash_mma_args import kernel_mask_args

    card = cs.card_line()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cs.log(card, f"sms={sms}", f"torch {torch.__version__}")
    libs = build(args.sources)
    cfg = aki_4b()
    ph, sg = cfg.phi3, cfg.siglip
    n_vis = cfg.perceiver.num_latents
    b, t_adm = cs.SERVE_SLOTS, cs.SERVE_BUCKET + n_vis - 1
    gen = torch.Generator(device="cuda").manual_seed(13)
    shapes = {
        "tower": dict(dims=(b, sg.num_patches, sg.num_patches, sg.num_heads, sg.num_heads,
                            sg.head_dim), rects=None, lens=None, causal=False),
        "admission": dict(dims=(b, t_adm, t_adm, ph.num_heads, ph.num_heads, ph.head_dim),
                          rects=[(1, 1 + n_vis, 40 + n_vis)], lens=cs.serving_lengths(cfg),
                          causal=True),
    }
    record = {"card": card, "sms": sms, "sources": args.sources, "rounds": args.rounds,
              "placements": args.placements, "warm_ms": args.warm, "cases": {}}
    spacers = []
    for shape, c in shapes.items():
        bb, t, s, h, _, d = c["dims"]
        q, k, v, spec = cs.case_inputs(*c["dims"], gen, c["rects"])
        kv_valid = None if c["lens"] is None else cs.prefix_valid(c["lens"], s)
        kw = dict(spec=spec, kv_valid=kv_valid, q_offset=0, causal=c["causal"])
        mask = kernel_mask_args(spec, kv_valid, 0, bb, s, q.device)
        view = lambda x: x.view(bb, x.shape[1], h, cs.FLAT_DP)  # noqa: E731
        allowed = cs.case_allowed(bb, t, s, spec, kv_valid, c["causal"])
        mask_b = None if allowed is None else allowed[:, None]
        # placements: the same inputs copied to other addresses, each set
        # allocated after a spacer of p * (2 MiB + 64 KiB) + 1 bytes
        sets = []
        for p in range(args.placements):
            if p:
                spacers.append(torch.empty(p * (2 ** 21 + 2 ** 16) + 1, dtype=torch.uint8,
                                           device="cuda"))
            qp, kp, vp = (x.clone() for x in (q, k, v))
            sets.append(dict(K1=(qp, kp, vp), K6=(cs.pad_heads(qp, True), cs.pad_heads(kp, True),
                                                 cs.pad_heads(vp, False))))
        for kern in ("K1", "K6"):
            name = f"{kern}_{shape}"
            calls, sdpas, outs, addrs = [], [], [], []
            for st in sets:
                qx, kx, vx = st[kern]
                out = torch.empty_like(qx)
                flat = None if kern == "K1" else h
                calls.append([launcher(lib, qx, kx, vx, out, mask, c["causal"], d ** -0.5,
                                       heads=flat) for lib in libs])
                # this checkout's wrapper: marshalling and a new output each call
                calls[-1].append((lambda qx=qx, kx=kx, vx=vx: flash_mma_attention(qx, kx, vx, **kw))
                                 if kern == "K1" else
                                 (lambda qx=qx, kx=kx, vx=vx:
                                  flash_mma_attention_flat(qx, kx, vx, h, d, **kw)))
                qt, kt, vt = ((x if kern == "K1" else view(x)).transpose(1, 2)
                              for x in (qx, kx, vx))
                sdpas.append(lambda qt=qt, kt=kt, vt=vt:
                             torch.nn.functional.scaled_dot_product_attention(
                                 qt, kt, vt, attn_mask=mask_b, scale=d ** -0.5))
                outs.append(out)
                addrs.append([hex(x.data_ptr()) for x in (qx, kx, vx, out)])
            rows = forward_block_rows(bb, t, h, d if kern == "K1" else cs.FLAT_DP)
            qx, kx, vx = sets[0][kern]
            gate_in = ((qx, kx, vx) if kern == "K1" else (view(qx), view(kx), view(vx)))
            gate_kw = kw if kern == "K1" else dict(kw, scale=d ** -0.5)
            for i, call in enumerate(calls[0][:len(libs)]):
                outs[0].zero_()
                call()
                torch.cuda.synchronize()
                got = outs[0] if kern == "K1" else view(outs[0])
                cs.forward_gates(f"{name} build {i}", got, *gate_in, gate_kw)
            builds = [*args.sources, "wrapper of this checkout"]
            names = {"kernel": sorted(cs.kernel_split_ms(calls[0][-1], 2)),
                     "sdpa": sorted(cs.kernel_split_ms(sdpas[0], 2))}
            cs.log(f"{name} device kernels: {names}")
            # variants: (warm-up ms, placement, build); A B ... B A over rounds
            variants = [(w, p, i) for w in args.warm for p in range(len(sets))
                        for i in range(len(builds))]
            lib_variants = [(w, p) for w in args.warm for p in range(len(sets))]
            runs = {v: [] for v in variants + lib_variants}
            for r in range(args.rounds):
                for v in (variants if r % 2 == 0 else variants[::-1]):
                    warm_up(v[0])
                    witness = cs.gemm_witness()
                    runs[v].append(dict(launch_times(calls[v[1]][v[2]]), witness=witness,
                                        burst_ms=cs.burst_ms(calls[v[1]][v[2]])))
                for v in lib_variants:
                    warm_up(v[0])
                    witness = cs.gemm_witness()
                    runs[v].append({"device_ms": cs.device_ms(sdpas[v[1]]),
                                    "burst_ms": cs.burst_ms(sdpas[v[1]]),
                                    "clock": cs.sm_clock(), "witness": witness})
            rec = {"block_rows": rows, "kernel_names": names, "variants": []}
            for v in variants + lib_variants:
                ts = [x["device_ms"] for x in runs[v]]
                what = "SDPA" if len(v) == 2 else f"build {v[2]} ({builds[v[2]]})"
                rec["variants"].append({"warm_ms": v[0], "placement": v[1], "what": what,
                                        "addresses_q_k_v_out": addrs[v[1]], "rounds": runs[v],
                                        "median": statistics.median(ts), "min": min(ts),
                                        "max": max(ts)})
                launch = ("" if len(v) == 2 else " launch ms min/max (seen) per round "
                          + str([(round(x["launch_min"], 4), round(x["launch_max"], 4),
                                  x["launches_seen"]) for x in runs[v]]))
                cs.log(f"{name} warm {v[0]} ms placement {v[1]} {what}: device ms median "
                       f"{statistics.median(ts):.6f} min {min(ts):.6f} max {max(ts):.6f} rounds "
                       f"{[round(x, 6) for x in ts]} burst ms "
                       f"{[round(x['burst_ms'], 6) for x in runs[v]]}{launch} GEMM witness "
                       f"TFLOP/s (profiler, events) "
                       f"{[x['witness'] for x in runs[v]]} clocks "
                       f"{[x['clock'] for x in runs[v]]} block_rows={rows}")
            record["cases"][name] = rec
            del calls, sdpas, outs
        del q, k, v, sets
        spacers.clear()
        cs.free_cuda()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f)
    cs.log(card)
    print(json.dumps({"ok": True, "out": args.out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the aki_torch port's paths on one NVIDIA GPU and hold each of its
CUDA kernels against the plain PyTorch version.

Usage, from the root of a checkout, on a machine with one H100:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi); no card -> exit 1;
  2. build: nvcc for sm_90a of the kernel sources (KERNEL_SOURCES), one nvcc
     per source, all started together;
  3. kernels: the flash forward against its plain version in bf16 at the
     generation path's shapes and on edge cases of its tile classes (skip,
     full, partial: 16 images with edges at tile boundaries and one off,
     lengths no block size divides, q_offset with T < S, GQA 32/8 with the
     lse, dead rows, kv_valid holes inside full tiles, 192-row blocks, base-2
     score spreads past exp2's flush at 2^-126), each with the classes it
     ran as the kernel counts them (flash_mma.count_tiles), held to the
     mirror flash_mma_args.tile_classes, with times beside the bound and
     the PyTorch library call: the wrapper's and SDPA's call times (CUDA
     events) and their device times alone (torch.profiler);
  4. generation: aki_4b() at full width (27-layer SigLIP, 6-layer Perceiver,
     32-layer Phi-3.5-mini), random bf16 weights from a seeded generator,
     32 greedy tokens for two requests (one 384x384 image + a prompt of
     ~60 text tokens with max_len 1024, and ~900 with max_len 1280);
     every count is zeroed just before each request and read just after;
  5. prefill in place: last-position logits with the kernel against the
     plain attention on the same model and request;
  6. the frozen tower's forward at the training batch (2 x 729 patches),
     then the forward kernel's output and lse and the backward kernels (dq,
     dkv) against the plain versions in bf16, at the training shape (2 x
     655 tokens: 512 text tokens, one <image> spliced to 144 vision tokens,
     the second row right-padded), the SigLIP non-causal shape and edge
     cases of the backward's tile classes and walks (16 images with edges
     at tile boundaries and one off, q_offset with T < S and kv_valid
     holes, GQA 32/8 at the training length, dead rows, 128-row blocks at
     both widths, base-2 score spreads past exp2's flush), each under a
     time limit, with the tile classes each kernel ran (count_tiles) held
     to the mirror and every class run by dq and dkv at widths 80 and 96;
     at the training shape the pair's and the whole call's device times
     (torch.profiler, by kernel name, and a CUDA-event burst), warm and
     with a cold L2 (a 64 MB write before each call), beside the bound,
     the plain backward and SDPA's backward timed the same ways, and the
     forward with lse timed on the device alone beside SDPA's forward;
  7. whole-model gradients: aki_4b() at full width and depth (fp32 master
     weights, bf16 compute, remat) on one training batch, loss and
     gradients with the kernels against the plain attention, both against
     f32 compute, with the launches of that one step;
  8. the Trainer at full aki_4b() width: bf16 frozen tower, remat,
     grad_accum 2, four AdamW steps on the same two micro-batches; loss,
     grad_norm, step ms, tokens/s, peak memory and launches per step;
  9. the fused "op + int8 quantize" kernels (rms, ln, silu*mul, gelu)
     against their plain versions at the W8A8 serving prefill's shapes (48
     rows of 655 decoder tokens, 48 images of 729 patches) and at phase
     11's one-request prefills, each timed on the device warm and cold
     (torch.profiler by kernel name; a 64 MB write before each cold call)
     and by CUDA events beside the bound; then 1, 7 and 1101 rows and 7 rows
     at widths 128 to 8192, with all-zero and huge edge rows; each launch
     plan held to its mirror (fused_quant.row_plan);
 10. the int8-KV decode attention kernel against its plain version at the
     serving cache (32 layers, 48 rows, 704 slots, 32 heads x 96) with
     ragged lengths, both end layers, a live width below the rows and a GQA
     case, at phase 11's one-row caches (1024 and 1280 slots) at its first
     and last decode lengths, and at every cluster size the wrapper picks
     (1, 2, 4, 8 blocks per head and row) on lengths at the edges of the
     split; timed full, ragged and at the one-row caches' last lengths on
     the device over the 32 layers in turn (a decode step's reads), warm on
     one layer, cold, and by CUDA events, beside the bound;
 11. int8 generation: aki_4b() at full width and depth quantized W8A8
     (tower included) with the int8 KV cache, its prefill logits against
     the bf16 and f32 runs of the same weights, and 32 greedy tokens for the
     two phase-4 requests, with the launches of each call;
 12. the serving engine as the JAX package's bench.py configures it (48
     slots, max_len 704, bucket 512, batched admission of 48, decode chunks
     of 8, W8A8, int8 KV, uint8 images, tail compaction, uploads of 16)
     draining 96 requests under torch.profiler, with the decode and fused
     quantize kernels' device ms and their launches seen of those issued,
     the tokens of the first 8 held to the one-shot path (teacher-forced);
     the bf16-probability prefill attentions timed against the flash kernel
     at the serving prefill shapes;
 13. the two kernels no path of the package runs, through their wrappers at
     AKI-4B widths: the flat padded-head forward (K6) at the serving
     admission (48 rows of 655 decoder tokens, 32 heads x 128, MMA, ragged),
     at the tower (48 x 729, 16 x 128, non-causal) and on edge cases, held
     to its plain version and, on its real lanes, to the standard forward
     on the unpadded tensors; the int8-operand forward (K7) at the same two
     shapes, at request (a) and on edge cases, held to its plain version and
     to f32 attention, with its routes to the bf16 forward (GQA, 1043 and
     1025 tokens) counted, and on edge cases of its tile classes at widths
     80 and 96 (16 images on and off tile edges, q_offset with holes, three
     heads at D = 72, T = 37, dead rows, 192-row blocks, T = S = 1024), the
     tiles each of its two passes ran held to the mirror (every class at
     both widths) and its launch plan to flash_mma_q8.q8_plan; its device
     time alone (warm over SPREAD_ROUNDS rounds beside K1 on the same
     tensors, and cold), its call's and the wrapper's by CUDA events,
     beside the bound and the bf16-P attention;
     K1 itself at the two 48-row shapes against its plain version, timed
     beside SDPA on the same unpadded tensors (device times over
     SPREAD_ROUNDS rounds, each with the SM clock); K6's edge cases; the gate
     that the forward's cases ran every tile class at each width (80, 96,
     128); and how far K6 and K1 sit from a plain version that folds the
     scale into q in bf16, as the JAX wrappers do.
Then one JSON line of kernels, the card line, and the result line.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

# H100 SXM data-sheet peaks at its full 700 W power limit; the card's own
# limit is printed beside every number
PEAK_BF16_FLOPS = 989e12      # dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12        # f32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12      # HBM3
NEW_TOKENS = 32
# |kernel - plain| <= ATOL + RTOL * |plain| elementwise: both round the
# output to bf16 (one ulp is 2^-8 relative, 0.0156 at |o| in [2, 4)) and
# round P to bf16 at different points (the kernel before normalising).
ATOL, RTOL = 2e-2, 1e-2
# That bound is loose for long rows, where |o| ~ 0.05 and a key masked in
# or out by mistake moves the output by only ~1/n. The sharper gate: against
# attention in f32 on the same bf16 inputs, the kernel's mean |error| stays
# within F32_ERR_RATIO of the plain version's (it is below it when right).
F32_ERR_RATIO = 1.5
# Prefill logits through 59 attention layers of random bf16 weights: the
# plain bf16 path itself reaches only ~0.9985 cosine to the same weights in
# f32 on an H100, so two bf16 paths that round in different places sit
# ~0.998 apart. Hence 0.995 between kernel and plain, the same argmax, and
# the kernel no further from the f32 run than twice the plain path's gap.
COSINE_MIN = 0.995
# Backward, kernel against plain on the same bf16 inputs, o and lse: both
# round p and ds to bf16 and the outputs to bf16, and differ only in the f32
# summation order (which can flip one bf16 rounding of a p or ds term) and
# exp2's last bit. Element-wise |kernel - plain| <= G_ATOL * max|plain| +
# G_RTOL * |plain|: the max-scaled term covers outputs that are small
# sums of large terms. The sharper gate is the f32 one (F32_ERR_RATIO).
G_ATOL, G_RTOL = 2e-2, 2e-2
# The forward's lse against the plain logsumexp of the same bf16 inputs, in
# base 2 (f32 sums of ~700 terms in another order): 1e-3 absolute.
LSE_ATOL = 1e-3
# Whole-model loss, kernel against plain attention, bf16 compute: two bf16
# paths that round in different places (see COSINE_MIN) through 32 layers.
LOSS_RTOL = 1e-2
# Per-tensor gradient cosine, kernel against plain: the same two bf16 paths
# through 32 layers forward and back (0.9955-0.9989 on an H100). The
# sharper gate: against the same weights with f32 compute and plain
# attention, the kernel's 1 - cosine is at most twice the plain path's.
GRAD_COSINE_MIN = 0.99
TRAIN_STEPS = 4
# Fused quantize kernels against their plain versions on the same bf16 rows:
# both compute h in f32 but sum the row statistics in another order (and the
# kernel may contract a multiply-add), so a value at a rounding tie of h / s
# can land one int8 step away; the scales max|h| / 127 agree to f32 rounding.
QUANT_STEP_MAX, QUANT_SCALE_RTOL = 1, 1e-5
# Int8 serving against bf16 on the same weights, prefill logits at the last
# position: the JAX package's own full-depth W8A8 + int8-KV drift gate
# (tests/test_quant_drift.py:73-74): mean |int8 - bf16| below 0.25 of the bf16
# logits' standard deviation and the largest below 2.0 of it. The int8 path
# is held to the f32 run of the same weights by the same bound.
DRIFT_MEAN_MAX, DRIFT_MAX_MAX = 0.25, 2.0
# elementwise f32 operations per value of each fused quantize op (its
# prologue, then |h|, the max, the division, the rounding and the clamp)
QUANT_OPS_PER_VALUE = {"rms": 10, "ln": 12, "silu": 11, "gelu": 16}
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_BUCKET, SERVE_REQUESTS = 48, 704, 512, 96
# Phase 9's edge widths: one chunk a lane up to one warp's widest and past it
QUANT_EDGE_WIDTHS = (128, 1152, 3072, 4352, 8192)
# Phase 10 must run the decode kernel at each cluster size it can launch
CLUSTER_SIZES_WANT = (1, 2, 4, 8)
# Phase 10's ragged lengths of the serving cache: one key, tile edges, full
SERVE_RAGGED = [1, 63, 64, 65, 255, 511, 655, 704] * (SERVE_SLOTS // 8)
# The port's kernels by a part of their device name, and the launch
# counters (launch_counts, int8_launch_counts) that count their launches
PORT_KERNEL_COUNTERS = {"flash_mma_fwd": ("fwd",), "flash_mma_dq": ("dq",),
                        "flash_mma_dkv": ("dkv",),
                        "fused_quant_kernel": ("rms", "ln", "silu", "gelu"),
                        "decode_attention_kernel": ("decode",)}
# Rounds of the device times at phase 13's 48-row shapes (median kept, each
# round recorded): one round moved by up to 30% between runs
SPREAD_ROUNDS = 5
# The server's tokens against the one-shot path on the same weights, for the
# first 8 requests. At random weights the top two logits can sit within the
# rounding that the server's batch changes (bf16 products of 48 rows, other
# summation orders), so exact agreement is not asked of every token: of the
# 8 first tokens at least 4 must equal a one-shot generate's. Every served
# token is held instead under teacher forcing: the one-shot prefill and
# decode steps are fed the server's own tokens, and at each position the
# one-shot's best logit may lead the served token's by at most twice the
# drift delta that batching moves a logit (the largest |batched - alone| of
# the checked requests' prefill logits over their std): if each logit moves
# by at most delta, the server's argmax trails the one-shot's by at most
# 2 delta. A wrong cache, position or slot gives a token drawn from the
# wrong context, several std below the best.
SERVE_FIRST_TOKEN_CHECKS, SERVE_FIRST_TOKEN_MIN, SERVE_GAP_FACTOR = 8, 4, 2.0
KERNEL_SOURCES = ("flash_mma_fwd", "flash_mma_bwd", "fused_quant", "decode_attention",
                  "flash_mma_q8")
TRAIN_TEXT = 512          # text tokens per training row; one <image> -> 144
# Phase 6: a backward case (forward, backward, plain versions) and its
# timings each end within these seconds, or the script fails: the
# producer and consumers of a kernel that walk different tile lists wait
# forever; the L2 flush between cold calls writes FLUSH_BYTES (the L2 is
# 50 MB; a train step's attention inputs, ~40 MB, arrive from HBM)
BWD_CASE_SECONDS, BWD_TIMING_SECONDS = 120, 300
FLUSH_BYTES = 64 << 20


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def print_ptxas(name: str, report: str) -> None:
    """The lines of an nvcc -Xptxas -v report that matter: each entry's
    registers, spills, shared memory and any serialised-wgmma note."""
    for line in report.splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry", "Performance Loss",
                                   "smem")):
            log(f"  ptxas {name}:", line.strip())


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events). The
    inputs stay in L2 as they are on the main path, where the projections
    that produce q/k/v ran just before."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_call(name: str, fn, reps: int = 3, host: bool = False) -> None:
    """The device's idle share of ``fn``: each of ``reps`` calls gives its
    own host wall time and the device time of what it ran (torch.profiler
    tracing the device only, one stream: device events do not overlap);
    the call with the median idle share is printed with its five costliest
    kernels, beside every call's idle share. The port's kernels are also
    given as launches seen of launches issued (their wrappers' counts) and
    as the mean time of a seen launch times the launches issued: the
    profiler can miss launches, and then the busy time is a lower bound
    and the idle share an upper one. ``host`` adds one more call traced on
    the host as well, and prints its costliest host operations by self
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def issued() -> dict[str, int]:
        n = {**int8_launch_counts(), **launch_counts()}
        return {k: sum(n[c] for c in cs) for k, cs in PORT_KERNEL_COUNTERS.items()}

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        before = issued()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launched = {k: v - before[k] for k, v in issued().items()}
        per_name: dict[str, float] = {}
        seen: dict[str, int] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
                seen[e.name] = seen.get(e.name, 0) + 1
        busy_ms = sum(per_name.values())
        port = {}
        for k, n in launched.items():
            names = [x for x in per_name if k in x]
            got = sum(seen[x] for x in names)
            if n or got:
                ms = sum(per_name[x] for x in names)
                port[k] = (got, n, ms / got * n if got else None)
        runs.append((1 - busy_ms / wall_ms, wall_ms, busy_ms, per_name, port))
    if any(r[2] == 0 for r in runs):
        log(f"profile {name}: wall_ms={[round(r[1], 3) for r in runs]} device time "
            f"not measured (the profiler saw no device events)")
        return
    runs.sort(key=lambda r: r[0])
    idle, wall_ms, busy_ms, per_name, port = runs[len(runs) // 2]
    if host:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
            torch.cuda.synchronize()
        top_host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:8]
        log(f"profile {name} host: " + "; ".join(
            f"{e.key[:50]}={e.self_cpu_time_total / 1e3:.1f}ms x{e.count}" for e in top_host))
    kern = {n: sum(v for k, v in per_name.items() if n in k) for n in PORT_KERNEL_COUNTERS}
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"profile {name}: median of {reps} calls: wall_ms={wall_ms:.3f} "
        f"device_busy_ms={busy_ms:.3f} idle_share={idle:.3f} "
        f"(all calls {[round(r[0], 3) for r in runs]}) "
        + " ".join(f"{n}_ms={v:.3f}" for n, v in kern.items() if v or n == "flash_mma_fwd")
        + " port launches seen/issued, ms per seen launch x issued: "
        + (", ".join(f"{k} {g}/{n} {'-' if ms is None else f'{ms:.3f}'}"
                     for k, (g, n, ms) in port.items()) or "none")
        + " (all calls: " + str([{k: v[:2] for k, v in r[4].items()} for r in runs]) + ")"
        + " top=" + "; ".join(f"{k[:60]}={v:.3f}" for k, v in top))


def prompt_ids(cfg, n_txt: int, gen: torch.Generator) -> torch.Tensor:
    """One chat prompt of ``n_txt`` ids: <s> <|user|> <image> text...
    <|end|> <|assistant|>, the text drawn from ``gen``."""
    text = torch.randint(100, 32000, (n_txt - 5,), generator=gen)
    head = torch.tensor([1, 32010, cfg.media_token_id])
    tail = torch.tensor([32007, cfg.assistant_token_id])
    return torch.cat([head, text, tail])[None].to(torch.int32)


def request_prompts(cfg) -> list[dict]:
    """The two requests of phases 4 and 11: (a) ~60 text tokens with
    max_len 1024, (b) ~900 with max_len 1280, their ids drawn from one seeded
    generator, with the spliced length and the image rectangle of each."""
    host_gen = torch.Generator().manual_seed(0)
    requests = [dict(name="a", n_txt=60, max_len=1024),
                dict(name="b", n_txt=900, max_len=1280)]
    for r in requests:
        r["ids"] = prompt_ids(cfg, r["n_txt"], host_gen)
        r["t_full"], r["rect"] = request_spec(cfg, r["ids"], cfg.perceiver.num_latents)
    return requests


def quant_timing_shapes(cfg) -> list[tuple[str, int, int]]:
    """(op, rows, width) of phase 9's timed fused quantize cases: the W8A8
    serving prefill (48 rows of the bucket's spliced length through the
    decoder, 48 images through the tower) and the one-request prefills
    (the spliced lengths of request_prompts through the decoder, one image
    through the tower)."""
    ph, sg = cfg.phi3, cfg.siglip
    rows_dec = SERVE_SLOTS * (SERVE_BUCKET + cfg.perceiver.num_latents - 1)
    one_dec = [r["t_full"] for r in request_prompts(cfg)]
    gelu_d = (sg.intermediate_size + 127) // 128 * 128
    return [(op, rows, d) for op, d, big, small in (
        ("rms", ph.hidden_size, rows_dec, one_dec),
        ("silu", ph.intermediate_size, rows_dec, one_dec),
        ("ln", sg.hidden_size, SERVE_SLOTS * sg.num_patches, [sg.num_patches]),
        ("gelu", gelu_d, SERVE_SLOTS * sg.num_patches, [sg.num_patches]))
        for rows in (big, *small)]


def request_spec(cfg, ids: torch.Tensor, n_vis: int):
    """Spliced length and the MMA rectangle of a one-image prompt."""
    row = ids[0].tolist()
    img, asst = row.index(cfg.media_token_id), row.index(cfg.assistant_token_id)
    return len(row) + n_vis - 1, (img, img + n_vis, asst + n_vis)


def allowed_work(b, t, s, h, hkv, d, allowed, has_valid):
    """FLOPs and bytes that the masked attention itself needs, whatever the
    kernel's tiling, for the roofline bound: 4*d FLOPs per head and allowed
    (query row, key) pair (QK^T and PV); q read and out written once; K, V
    (and kv_valid, when given) read once for each key that some row may
    attend. ``allowed`` is the (B, T, S) bool mask, None for all pairs."""
    if allowed is None:
        pairs, keys = b * t * s, b * s
    else:
        pairs, keys = int(allowed.sum()), int(allowed.any(dim=1).sum())
    nbytes = 2 * (2 * b * t * h * d) + keys * (2 * 2 * hkv * d + 4 * has_valid)
    return 4 * d * h * pairs, nbytes


def prefix_valid(lens, s) -> torch.Tensor:
    """(B, s) int32 key validity: the first lens[b] keys of row b."""
    lens = torch.tensor(lens, device="cuda")[:, None]
    return (torch.arange(s, device="cuda")[None] < lens).to(torch.int32)


def forward_gates(label, got, q, k, v, kw, exact=None, zero_rows=None) -> dict:
    """Hold the forward kernel's output ``got`` against the plain forward on
    the same bf16 inputs, element-wise, and against attention in f32 on
    those inputs (``exact``, computed when not given): the kernel's mean
    |error| stays within F32_ERR_RATIO of the plain version's.
    ``zero_rows`` = (batch row, query rows) that must come out exactly 0.
    Fails the script on a miss; returns the errors."""
    from aki_torch.ops.flash_mma import flash_mma_attention_reference

    want = flash_mma_attention_reference(q, k, v, **kw)
    diff = (got.float() - want.float()).abs()
    abs_err = diff.max().item()
    rel_err = abs_err / max(want.float().abs().max().item(), 1e-30)
    if exact is None:
        exact = flash_mma_attention_reference(q.float(), k.float(), v.float(), **kw)
    kernel_vs_f32 = (got.float() - exact).abs().mean().item()
    plain_vs_f32 = (want.float() - exact).abs().mean().item()
    ok = (bool(torch.isfinite(got).all())
          and bool((diff <= ATOL + RTOL * want.float().abs()).all())
          and kernel_vs_f32 <= F32_ERR_RATIO * plain_vs_f32 + 1e-7)
    if zero_rows is not None:
        ok = ok and bool((got[zero_rows[0], zero_rows[1]] == 0).all())
    log(f"{label}: q={tuple(q.shape)} k={tuple(k.shape)} causal={kw['causal']} "
        f"max_abs_err={abs_err:.6g} max_rel_err={rel_err:.6g} "
        f"tol=|d|<={ATOL}+{RTOL}*|plain|; mean |err| vs f32 attention: kernel "
        f"{kernel_vs_f32:.4g} plain {plain_vs_f32:.4g} (kernel <= {F32_ERR_RATIO}x plain) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(f"chip_smoke: {label} disagrees with the plain forward")
    return dict(max_abs_err=abs_err, max_rel_err=rel_err, mean_abs_err_vs_f32=kernel_vs_f32,
                plain_mean_abs_err_vs_f32=plain_vs_f32)


def case_inputs(b, t, s, h, hkv, d, gen, rects=None):
    """Seeded bf16 q (B,T,H,D), k, v (B,S,Hkv,D) on the card, and the MMA
    spec of ``rects`` ((img_start, txt_start, txt_end) per image, the same
    for every batch row) or None."""
    from aki_torch.ops.masks import MMASpec

    q = torch.randn(b, t, h, d, device="cuda", generator=gen).to(torch.bfloat16)
    k = torch.randn(b, s, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn(b, s, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
    spec = None
    if rects is not None:
        spec = MMASpec(*(torch.tensor([[r[i] for r in rects]] * b, dtype=torch.int32,
                                      device="cuda") for i in range(3)))
    return q, k, v, spec


def case_allowed(b, t, s, spec, kv_valid, causal, q_offset=0):
    """The (B, T, S) pairs the mask allows, None for all of them."""
    from aki_torch.ops.masks import allowed_mask, causal_spec

    if causal:
        return allowed_mask(spec or causal_spec(b, "cuda"), t, s, kv_valid, q_offset)
    if kv_valid is not None:
        return (kv_valid[:, None, :] != 0).expand(b, t, s)
    return None


def lse_gate(lse, q, k, kw) -> tuple[float, bool]:
    """The forward's base-2 row logsumexp against the plain one on the same
    bf16 inputs: (largest error on the finite rows, whether it is within
    LSE_ATOL and +inf on the same rows)."""
    from aki_torch.ops.flash_mma_bwd import flash_mma_lse_reference

    want = flash_mma_lse_reference(q, k, **kw)
    finite = torch.isfinite(want)
    err = (lse - want)[finite].abs().max().item() if finite.any() else 0.0
    return err, bool((torch.isfinite(lse) == finite).all()) and err <= LSE_ATOL


def tile_gate(label, counts, b, t, s, h, spec, kv_valid, q_offset, causal, width) -> dict:
    """The tile classes that one kernel's launch ran, as the kernel counted
    them (``counts``: its row of flash_mma.count_tiles, consumer
    warpgroups' 64 query rows x 64 keys, over heads, batch rows and tiles),
    with the padded width; fails the script unless they equal the classes
    of the mirror flash_mma_args.tile_classes, for each of the ``h`` query
    heads (the backward's dkv counts each head of a GQA group)."""
    from aki_torch.ops.flash_mma_args import TILE_CLASS_NAMES, tile_classes

    ran = counts.tolist()
    offset = torch.as_tensor(q_offset).cpu().expand(b)    # gives the mirror B rows
    cls = tile_classes(spec if causal else None, kv_valid, offset, t, s, causal)
    mirror = [h * n for n in torch.bincount(cls.flatten().long(), minlength=3).tolist()]
    if ran != mirror:
        raise SystemExit(f"chip_smoke: {label} ran tiles {ran} (skip, full, partial), "
                         f"the mirror's classes give {mirror}")
    return {"width": width, **dict(zip(TILE_CLASS_NAMES, ran))}


def spread_qk(q, k, gen, distinct: bool = False):
    """q and k of q's and k's shapes whose scaled base-2 scores spread past
    126 along each row, so that exp2 in the kernel flushes some p and alpha
    to 0 where the plain version keeps them as subnormals: q near 2 in every
    lane, k near a per-key level drawn from [-2, 3], and level 8 at keys
    137, 237, ... (at head dim 96 a row max 141-283 above the other keys,
    reached after two KV tiles whose max it passes by more than 126).

    Those keys all point along (1, ..., 1), so where two of them share a
    row's p, dq = sum ds k is a difference of two near-equal terms ~30
    times its size, and one flipped bf16 rounding of a ds moves it by more
    than the backward's gate, which scales with the largest dq, allows
    (for the earlier mma.sync kernels as for these). ``distinct`` (the backward's
    case) adds to every key a component of std 2 whose lanes sum to 0: the
    scores move by well under one base-2 unit, and the keys point apart."""
    b, s, hkv, d = k.shape
    level = torch.rand(b, s, 1, 1, device="cuda", generator=gen) * 5 - 2
    level[:, 137::100] = 8.0
    noise = lambda x: 0.05 * torch.randn(x.shape, device="cuda", generator=gen)  # noqa: E731
    q = (2.0 + noise(q)).to(torch.bfloat16)
    kf = level + noise(k)
    if distinct:
        r = 2.0 * torch.randn(k.shape, device="cuda", generator=gen)
        kf = kf + r - r.mean(-1, keepdim=True)
    return q, kf.to(torch.bfloat16)


def ftz_band_terms(q, k, kw) -> int:
    """Allowed (row, key) terms whose scaled base-2 score lies 126 to 149
    below their row's max: p = 2^-126 .. 2^-149, subnormal in f32, which the
    kernel's exp2 flushes to 0."""
    from aki_torch.ops.flash_mma_args import LOG2E

    b, t, h, d = q.shape
    s = k.shape[1]
    allowed = case_allowed(b, t, s, kw["spec"], kw["kv_valid"], kw["causal"], kw["q_offset"])
    kx = k.float().repeat_interleave(h // k.shape[2], 2)
    sc = torch.einsum("bthd,bshd->bhts", q.float(), kx) * (d ** -0.5 * LOG2E)
    if allowed is not None:
        sc = sc.masked_fill(~allowed[:, None], -math.inf)
    gap = sc.amax(-1, keepdim=True) - sc
    return int(((gap > 126) & (gap <= 149)).sum())


def time_forward(name, q, k, v, kw, rounds=1) -> dict:
    """The bf16 forward (K1/K2) through its wrapper on q, k, v: the call's
    time (ms, CUDA events around the wrapper) and the kernel's device time
    alone (device_ms), beside the bound, the plain version and one SDPA call
    with the same boolean mask on the same tensors (library_ms, and
    library_device_ms: every device kernel of that call); the device times
    the median of ``rounds`` (device_rounds); the block rows the launch
    took."""
    from aki_torch.ops.flash_mma import (flash_mma_attention, flash_mma_attention_reference,
                                         forward_block_rows)

    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    allowed = case_allowed(b, t, s, kw["spec"], kw["kv_valid"], kw["causal"], kw["q_offset"])
    flops, nbytes = allowed_work(b, t, s, h, hkv, d, allowed, kw["kv_valid"] is not None)
    t_flops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if hkv != h:
        kt = kt.repeat_interleave(h // hkv, 1)
        vt = vt.repeat_interleave(h // hkv, 1)
    mask = None if allowed is None else allowed[:, None]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask)
    rec = dict(
        ms=cuda_ms(lambda: flash_mma_attention(q, k, v, **kw)),
        **device_rounds(lambda: flash_mma_attention(q, k, v, **kw), sdpa, rounds),
        block_rows=forward_block_rows(b, t, h, d),
        plain_ms=cuda_ms(lambda: flash_mma_attention_reference(q, k, v, **kw)),
        library_ms=cuda_ms(sdpa),
        bound_ms=max(t_flops, t_bytes),
        bound_by="operations" if t_flops >= t_bytes else "bytes",
        bound_flops=flops, bound_bytes=nbytes,
    )
    for key in ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms",
                "bound_by", "block_rows", "device_ms_rounds", "library_device_ms_rounds",
                "burst_ms_rounds", "library_burst_ms_rounds", "gemm_witness_tflops",
                "profiler_launches_seen_of"):
        if key in rec:
            log(f"  {name} {key}={rec[key]}")
    return rec


def kernel_case(name, b, t, s, h, hkv, d, gen, causal=True, rects=None,
                kv_valid=None, q_offset=0, timed=False, zero_rows=None, lse=False,
                spread=False):
    """One kernel-vs-plain comparison on the card; returns its record, with
    the tile classes the call ran. ``zero_rows`` = (batch row, query rows)
    that must come out exactly 0; ``lse`` also holds the forward's row
    logsumexp to the plain one (LSE_ATOL, +inf on the same rows);
    ``spread`` takes q and k from spread_qk."""
    from aki_torch.ops.flash_mma import count_tiles, flash_mma_attention, flash_mma_forward

    q, k, v, spec = case_inputs(b, t, s, h, hkv, d, gen, rects)
    if spread:
        q, k = spread_qk(q, k, gen)
    kw = dict(spec=spec, kv_valid=kv_valid, q_offset=q_offset, causal=causal)

    with count_tiles() as counts:
        if lse:
            got, lse_got = flash_mma_forward(q, k, v, with_lse=True, **kw)
        else:
            got = flash_mma_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    rec = dict(name=name, shape=[b, t, s, h, hkv, d], causal=causal,
               tiles=tile_gate(name, counts[0], b, t, s, h, spec, kv_valid, q_offset, causal,
                               80 if d <= 80 else 96),
               **forward_gates(f"kernel {name}", got, q, k, v, kw, zero_rows=zero_rows))
    if spread:
        rec["exp2_flush_band_terms"] = n_band = ftz_band_terms(q, k, kw)
        log(f"  {name} allowed terms 126-149 below their row's base-2 max "
            f"(exp2 flushes them): {n_band}")
        if n_band == 0:
            raise SystemExit(f"chip_smoke: kernel {name} has no score in the exp2 flush band")
    if lse:
        err, ok = lse_gate(lse_got, q, k, kw)
        rec["lse_max_abs_err"] = err
        log(f"  {name} lse_max_abs_err={err:.3g} (tol {LSE_ATOL}, +inf rows equal) "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise SystemExit(f"chip_smoke: kernel {name} lse disagrees with the plain one")
    log(f"  {name} tiles={rec['tiles']}")
    if timed:
        rec.update(time_forward(name, q, k, v, kw))
    return rec


def train_rows(cfg, gen: torch.Generator):
    """One training micro-batch of two rows, as a loader gives it (numpy):
    <s> <|user|> <image> question <|end|> <|assistant|> answer <|end|>, 512
    text tokens, labels on the answer only; row 1 right-padded after 400
    tokens. Images in [-1, 1] at 384x384."""
    import numpy as np

    from aki_torch.train.step import Batch

    n_q = 200
    rows, labels = [], []
    for _ in range(2):
        q = torch.randint(100, 32000, (n_q,), generator=gen)
        a = torch.randint(100, 32000, (TRAIN_TEXT - n_q - 6,), generator=gen)
        ids = torch.cat([torch.tensor([1, 32010, cfg.media_token_id]), q,
                         torch.tensor([32007, cfg.assistant_token_id]), a, torch.tensor([32007])])
        lab = ids.clone()
        lab[: n_q + 5] = -100
        rows.append(ids)
        labels.append(lab)
    ids, labels = torch.stack(rows), torch.stack(labels)
    valid = torch.ones_like(ids, dtype=torch.int32)
    valid[1, 400:] = 0
    ids[1, 400:] = cfg.pad_token_id
    labels[1, 400:] = -100
    s = cfg.siglip.image_size
    images = torch.rand(2, s, s, 3, generator=gen) * 2 - 1
    return Batch(ids.numpy(), images.numpy(), valid.numpy(), labels.numpy().astype(np.int64))


def train_spec(cfg, batch):
    """The spliced length, MMA spec and key validity of a training batch,
    from the port's own splice (on the CPU, zero embeddings)."""
    from aki_torch.models.fusion import splice_vision_tokens

    ids = torch.as_tensor(batch.input_ids)
    d = 8
    sp = splice_vision_tokens(torch.zeros(*ids.shape, d),
                              torch.zeros(ids.shape[0], cfg.perceiver.num_latents, d), ids,
                              torch.as_tensor(batch.attn_valid), cfg.media_token_id,
                              cfg.assistant_token_id)
    return sp.embeds.shape[1], sp.spec, sp.attn_valid


def backward_work(b, t, s, h, hkv, d, allowed):
    """(FLOPs, bytes) of the attention backward: 10*d FLOPs per head and
    allowed (query, key) pair (the five products S, dP, dV, dQ, dK; the
    recompute of S is one of them, nothing else is counted); q, o, dO read
    and dq written once (bf16), lse read once (f32), dk and dv written
    once, K and V (and kv_valid) read for the keys some row may attend.
    Returned for (dq kernel, dkv kernel, both): dq does S, dP, dQ (6d) and
    reads q, dO, lse, K, V and writes dq; dkv does S, dP, dV, dK (8d) and
    reads q, dO, lse, K, V and writes dk, dv."""
    pairs, keys = int(allowed.sum()), int(allowed.any(dim=1).sum())
    qb = 2 * b * t * h * d            # one (B,T,H,D) bf16 tensor
    kvb = 2 * b * s * hkv * d         # one (B,S,Hkv,D) bf16 tensor
    kv_read = keys * (2 * 2 * hkv * d + 4)
    lse_b = 4 * b * h * t
    both = (10 * d * h * pairs, 4 * qb + lse_b + kv_read + 2 * kvb)
    dq = (6 * d * h * pairs, 3 * qb + lse_b + kv_read)
    dkv = (8 * d * h * pairs, 2 * qb + lse_b + kv_read + 2 * kvb)
    return dq, dkv, both


def bound(work):
    t_flops, t_bytes = work[0] / PEAK_BF16_FLOPS * 1e3, work[1] / PEAK_HBM_BYTES * 1e3
    return max(t_flops, t_bytes), ("operations" if t_flops >= t_bytes else "bytes")


# Every profiler session of kernel_split_ms: its calls and the launches it
# saw per kernel name. The profiler can return fewer launches than were
# issued (none at all, at times), so a sum over the calls undercounts.
PROFILER_SESSIONS: list[tuple[int, dict[str, int]]] = []


def kernel_split_ms(fn, reps: int = 10) -> dict[str, float]:
    """Device ms per call of each kernel ``fn`` launches, by name, from
    torch.profiler over ``reps`` calls: the mean time of the launches the
    profiler saw times the launches per call (ceil(seen / reps): each name
    launched a fixed number of times per call), so that launches it missed
    do not count as time not spent; empty if it saw no device events. The
    session's counts go to PROFILER_SESSIONS."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total: dict[str, float] = {}
    seen: dict[str, int] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            total[e.name] = total.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            seen[e.name] = seen.get(e.name, 0) + 1
    PROFILER_SESSIONS.append((reps, seen))
    return {n: total[n] / seen[n] * math.ceil(seen[n] / reps) for n in total}


def profiler_shortfall(kernel: str | None = None) -> tuple[int, int]:
    """(launches seen, launches per call x calls) of the last profiler
    session, over the names holding ``kernel`` (all when None)."""
    reps, seen = PROFILER_SESSIONS[-1]
    names = [n for n in seen if kernel is None or kernel in n]
    return (sum(seen[n] for n in names),
            sum(math.ceil(seen[n] / reps) * reps for n in names))


def device_ms(fn, kernel: str | None = None, reps: int = 20) -> float | None:
    """Device time per call of ``fn`` alone: torch.profiler tracing the
    device over ``reps`` calls after a warm-up, the summed time of the
    device kernels whose name holds ``kernel`` (every device kernel of the
    call when None) over the count; None when the profiler saw none. Unlike
    cuda_ms it leaves out the host work and the small launches around the
    kernel (the wrapper's mask marshalling)."""
    split = kernel_split_ms(fn, reps)
    picked = [v for k, v in split.items() if kernel is None or kernel in k]
    return sum(picked) if picked else None


def device_rounds(fn, library, rounds: int) -> dict:
    """device_ms of the forward kernel in ``fn`` and of every kernel of
    ``library`` (the SDPA call), alternated over ``rounds`` rounds: the
    medians (device_ms, library_device_ms), the launches each profiler
    session saw of those issued (profiler_shortfall) and, for more than one round,
    each round's times, the same calls timed as one burst by CUDA events
    (burst_ms), the card's clocks read after each round's kernel (sm_clock)
    and the rate of a fixed GEMM timed just before it (gemm_witness): the
    spread's witnesses."""
    dev, lib, dev_ev, lib_ev, clocks, witness, seen = [], [], [], [], [], [], []
    for _ in range(rounds):
        if rounds > 1:
            witness.append(gemm_witness())
        dev.append(device_ms(fn, "flash_mma_fwd_kernel"))
        seen.append(profiler_shortfall("flash_mma_fwd_kernel"))
        if rounds > 1:
            dev_ev.append(burst_ms(fn))
            clocks.append(sm_clock())
        lib.append(device_ms(library))
        seen.append(profiler_shortfall())
        if rounds > 1:
            lib_ev.append(burst_ms(library))
    rec = dict(device_ms=median_of(dev), library_device_ms=median_of(lib),
               profiler_launches_seen_of=seen)
    if rounds > 1:
        rec.update(device_ms_rounds=dev, library_device_ms_rounds=lib, burst_ms_rounds=dev_ev,
                   library_burst_ms_rounds=lib_ev, clocks=clocks, gemm_witness_tflops=witness)
    return rec


def median_of(xs):
    """The median of the values that are not None; None if there are none."""
    xs = [x for x in xs if x is not None]
    return statistics.median(xs) if xs else None


def burst_ms(fn, reps: int = 20) -> float:
    """Time per call of ``reps`` calls of ``fn`` issued back to back, by CUDA
    events around the burst: the device time when the host issues faster
    than the device runs (calls of a few hundred us), and a check on
    device_ms that does not go through the profiler."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


_WITNESS: list = []


def gemm_witness() -> dict:
    """TFLOP/s of one 4096^3 bf16 GEMM (cuBLAS), by device_ms and by
    burst_ms: a fixed, compute-bound piece of work whose rate follows the
    card's state at the moment (clock, power) and the timer's, and nothing
    of the kernel under test."""
    if not _WITNESS:
        g = torch.Generator(device="cuda").manual_seed(99)
        _WITNESS.append(torch.randn(4096, 4096, device="cuda", generator=g).to(torch.bfloat16))
    a = _WITNESS[0]
    flop = 2 * 4096 ** 3 / 1e9
    ms = device_ms(lambda: a @ a)
    return {"profiler": None if ms is None else flop / ms,
            "events": flop / burst_ms(lambda: a @ a)}


def sm_clock() -> str:
    """The card's SM and memory clocks (MHz), power draw (W), temperature
    (C) and, where this nvidia-smi reads them, the active clock throttle
    reasons (a bit mask), as nvidia-smi reads them now."""
    fields = "clocks.sm,clocks.mem,power.draw,temperature.gpu"
    for query in (fields + ",clocks_throttle_reasons.active", fields):
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True)
        if out.returncode == 0:
            return out.stdout.strip().splitlines()[0]
    raise SystemExit(f"chip_smoke: nvidia-smi cannot read {fields}")


@contextlib.contextmanager
def time_limit(label: str, seconds: float):
    """Ends the script (exit 1, from a timer thread) unless the block
    finishes within ``seconds``: a kernel whose producer and consumers walk
    different lists of tiles waits on its ring forever, and a synchronize
    with it."""
    def expire():
        log(f"chip_smoke: {label} did not finish within {seconds} s")
        os._exit(1)

    timer = threading.Timer(seconds, expire)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


def cold_split_ms(fn, reps: int = 10) -> dict[str, float]:
    """kernel_split_ms of ``fn`` with the L2 cache flushed before each call
    by a FLUSH_BYTES read and write of a buffer of its own (bitwise_not, a
    kernel no call under test runs, left out by name): the device time of
    each kernel when its inputs arrive from HBM, as in a real step."""
    buf = torch.zeros(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")

    def call():
        buf.bitwise_not_()
        fn()

    return {n: ms for n, ms in kernel_split_ms(call, reps).items() if "bitwise_not" not in n}


def gradient_gates(got, want, exact) -> tuple[dict, bool]:
    """The kernels' (dq, dk, dv) against the plain backward's on the same
    bf16 inputs, element-wise (G_ATOL of the largest |plain| + G_RTOL of
    each), and against the f32 backward ``exact``: the kernel's mean |error|
    within F32_ERR_RATIO of the plain version's. Returns the errors per
    gradient and whether all passed."""
    rec, ok = {}, True
    for gname, g, w, x in zip(("dq", "dk", "dv"), got, want, exact):
        diff = (g.float() - w.float()).abs()
        scale = w.float().abs().max().item()
        k_err = (g.float() - x).abs().mean().item()
        p_err = (w.float() - x).abs().mean().item()
        ok = ok and (bool(torch.isfinite(g).all())
                     and bool((diff <= G_ATOL * scale + G_RTOL * w.float().abs()).all())
                     and k_err <= F32_ERR_RATIO * p_err + 1e-7)
        rec[gname] = dict(max_abs_err=diff.max().item(), max_abs=scale,
                          mean_abs_err_vs_f32=k_err, plain_mean_abs_err_vs_f32=p_err)
    return rec, ok


def backward_case(name, b, t, s, h, hkv, d, gen, causal=True, spec=None, rects=None,
                  kv_valid=None, q_offset=0, timed=False, zero_rows=None, spread=False):
    """The forward kernel's lse and the dq/dkv kernels against the plain
    versions on the card, in bf16, with the tile classes each kernel ran
    held to the mirror's (tile_gate) and the case under a time limit;
    returns the case's record. ``zero_rows`` = (batch row, query rows) whose
    dq must come out exactly 0; ``spread`` takes q and k from spread_qk.
    ``timed``: the times of the pair, of the whole run_backward call and of
    SDPA's backward, warm and with a cold L2 (see the phase-6 notes)."""
    from aki_torch.ops.flash_mma import (TILE_COUNTERS, count_tiles,
                                         flash_mma_attention_reference, flash_mma_forward)
    from aki_torch.ops.flash_mma_bwd import (backward_block_rows,
                                             flash_mma_backward_reference,
                                             flash_mma_lse_reference, run_backward)
    from aki_torch.ops.attention import attention_mask
    from aki_torch.ops.masks import MMASpec

    dev = "cuda"
    q = torch.randn(b, t, h, d, device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn(b, s, hkv, d, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(b, s, hkv, d, device=dev, generator=gen).to(torch.bfloat16)
    do = torch.randn(b, t, h, d, device=dev, generator=gen).to(torch.bfloat16)
    if spread:
        q, k = spread_qk(q, k, gen, distinct=True)
    if rects is not None:
        spec = MMASpec(*(torch.tensor([[r[i] for r in rects]] * b, dtype=torch.int32,
                                      device=dev) for i in range(3)))
    kw = dict(spec=spec, kv_valid=kv_valid, q_offset=q_offset, causal=causal)

    with time_limit(f"backward case {name}", BWD_CASE_SECONDS):
        with count_tiles() as counts:
            out, lse = flash_mma_forward(q, k, v, with_lse=True, **kw)
            got = run_backward(q, k, v, out, do, lse, **kw)
        torch.cuda.synchronize()
    width = 80 if d <= 80 else 96
    tiles = {kn: tile_gate(f"backward {name} {kn}", counts[i], b, t, s, h, spec, kv_valid,
                           q_offset, causal, width) for i, kn in enumerate(TILE_COUNTERS)}
    # the forward's output feeds delta = rowsum(dO * out) of both backwards
    # below, so a wrong out would pass their comparison: hold it first
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    o32 = flash_mma_attention_reference(q32, k32, v32, **kw)
    fwd = forward_gates(f"backward {name} forward with lse", out, q, k, v, kw, exact=o32)
    want = flash_mma_backward_reference(q, k, v, out, do, lse, **kw)
    lse_err, lse_ok = lse_gate(lse, q, k, kw)
    # the same backward in f32 on the same bf16 inputs, from its own f32
    # forward: the kernel should be as close to it as the plain version is
    exact = flash_mma_backward_reference(q32, k32, v32, o32, do32,
                                         flash_mma_lse_reference(q32, k32, **kw), **kw)
    rec = dict(name=name, shape=[b, t, s, h, hkv, d], causal=causal, lse_max_abs_err=lse_err,
               fwd_max_abs_err=fwd["max_abs_err"], tiles=tiles,
               block_rows=dict(zip(("dq", "dkv"), backward_block_rows(b, t, s, h, hkv))))
    grads, g_ok = gradient_gates(got, want, exact)
    rec.update(grads)
    ok = lse_ok and g_ok
    if zero_rows is not None:
        ok = ok and bool((got[0][zero_rows[0], zero_rows[1]] == 0).all())
    rec["max_abs_err"] = max(rec[n]["max_abs_err"] for n in ("dq", "dk", "dv"))
    log(f"backward {name}: q={tuple(q.shape)} k={tuple(k.shape)} causal={causal} "
        f"lse_max_abs_err={lse_err:.3g} (tol {LSE_ATOL}) "
        + " ".join(f"{n}: max_abs_err={rec[n]['max_abs_err']:.4g} of max {rec[n]['max_abs']:.4g}, "
                   f"mean |err| vs f32 kernel {rec[n]['mean_abs_err_vs_f32']:.4g} "
                   f"plain {rec[n]['plain_mean_abs_err_vs_f32']:.4g};" for n in ("dq", "dk", "dv"))
        + f" tol=|d|<={G_ATOL}*max+{G_RTOL}*|plain|, kernel <= {F32_ERR_RATIO}x plain vs f32; "
        f"tiles {tiles}; block rows {rec['block_rows']} {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(f"chip_smoke: backward case {name} disagrees with the plain version")
    if spread:
        rec["exp2_flush_band_terms"] = n_band = ftz_band_terms(q, k, kw)
        log(f"  {name} allowed terms 126-149 below their row's base-2 max "
            f"(exp2 flushes them): {n_band}")
        if n_band == 0:
            raise SystemExit(f"chip_smoke: backward case {name} has no score in the flush band")

    if timed:
        allowed = attention_mask(b, t, s, dev, spec if causal else None, kv_valid, q_offset,
                                 causal)[:, 0]
        w_dq, w_dkv, w_both = backward_work(b, t, s, h, hkv, d, allowed)
        # the library yardstick: SDPA's backward with the same boolean mask,
        # through autograd (its forward runs once, outside the timing)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        kr, vr = kt, vt
        if hkv != h:
            kr = kt.repeat_interleave(h // hkv, 1)
            vr = vt.repeat_interleave(h // hkv, 1)
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(
            qt, kr, vr, attn_mask=allowed[:, None])
        do_t = do.transpose(1, 2)
        run = lambda: run_backward(q, k, v, out, do, lse, **kw)  # noqa: E731
        sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
            sdpa_out, (qt, kt, vt), do_t, retain_graph=True)
        with time_limit(f"backward case {name} timing", BWD_TIMING_SECONDS):
            # every kernel of each call by name, device time per call
            split = kernel_split_ms(run)
            seen = profiler_shortfall()
            lib_split = kernel_split_ms(sdpa_bwd)
            lib_seen = profiler_shortfall()
            cold, lib_cold = cold_split_ms(run), cold_split_ms(sdpa_bwd)
            # the forward with lse at the same shape: its own bound (the lse
            # written once on top of the forward's bytes), plain and SDPA times
            f_flops, f_bytes = allowed_work(b, t, s, h, hkv, d, allowed, kv_valid is not None)
            rec["fwd_lse_bound_ms"], rec["fwd_lse_bound_by"] = bound((f_flops,
                                                                     f_bytes + 4 * b * h * t))
            with torch.no_grad():
                sdpa_fwd = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                    qt, kr, vr, attn_mask=allowed[:, None])
                rec["fwd_plain_ms"] = cuda_ms(lambda: flash_mma_attention_reference(q, k, v, **kw))
                rec["fwd_library_ms"] = cuda_ms(sdpa_fwd)
                rec["fwd_library_device_ms"] = device_ms(sdpa_fwd)
            pick = lambda sp, n: next((x for k_, x in sp.items() if n in k_), None)  # noqa: E731
            rec.update(
                ms=cuda_ms(run),
                device_ms=sum(split.values()) if split else None,
                burst_ms=burst_ms(run),
                split_ms=split, profiler_launches_seen_of=seen,
                fwd_lse_ms=cuda_ms(lambda: flash_mma_forward(q, k, v, with_lse=True, **kw)),
                fwd_lse_device_ms=device_ms(
                    lambda: flash_mma_forward(q, k, v, with_lse=True, **kw),
                    "flash_mma_fwd_kernel"),
                plain_ms=cuda_ms(lambda: flash_mma_backward_reference(q, k, v, out, do, lse,
                                                                      **kw)),
                library_ms=cuda_ms(sdpa_bwd),
                library_device_ms=sum(lib_split.values()) if lib_split else None,
                library_burst_ms=burst_ms(sdpa_bwd),
                library_split_ms=lib_split, library_profiler_launches_seen_of=lib_seen,
                dq_ms=pick(split, "flash_mma_dq"), dkv_ms=pick(split, "flash_mma_dkv"),
                cold_split_ms=cold, library_cold_split_ms=lib_cold,
                cold_dq_ms=pick(cold, "flash_mma_dq"), cold_dkv_ms=pick(cold, "flash_mma_dkv"),
                cold_device_ms=sum(cold.values()) if cold else None,
                library_cold_device_ms=sum(lib_cold.values()) if lib_cold else None,
                bound_flops=w_both[0], bound_bytes=w_both[1],
            )
        rec["bound_ms"], rec["bound_by"] = bound(w_both)
        rec["dq_bound_ms"], rec["dq_bound_by"] = bound(w_dq)
        rec["dkv_bound_ms"], rec["dkv_bound_by"] = bound(w_dkv)
        for key in ("ms", "device_ms", "burst_ms", "dq_ms", "dkv_ms", "cold_dq_ms",
                    "cold_dkv_ms", "cold_device_ms", "split_ms", "cold_split_ms",
                    "profiler_launches_seen_of", "plain_ms", "library_ms", "library_device_ms",
                    "library_burst_ms", "library_cold_device_ms", "library_split_ms",
                    "library_cold_split_ms", "library_profiler_launches_seen_of",
                    "bound_ms", "bound_by", "dq_bound_ms", "dkv_bound_ms", "bound_flops",
                    "bound_bytes", "fwd_lse_ms", "fwd_lse_device_ms", "fwd_lse_bound_ms",
                    "fwd_lse_bound_by", "fwd_plain_ms", "fwd_library_ms",
                    "fwd_library_device_ms"):
            log(f"  {name} {key}={rec[key]}")
    return rec


def backward_tile_coverage(records) -> dict:
    """Which tile classes dq and dkv ran over the backward cases, per padded
    width, as the kernels counted them (tile_gate); fails the script unless
    each kernel ran skip, full and partial at widths 80 and 96."""
    from aki_torch.ops.flash_mma_args import TILE_CLASS_NAMES

    cover: dict = {}
    for kn in ("dq", "dkv"):
        for r in records:
            tiles = r["tiles"][kn]
            by = cover.setdefault(kn, {}).setdefault(tiles["width"],
                                                     dict.fromkeys(TILE_CLASS_NAMES, 0))
            for n in TILE_CLASS_NAMES:
                by[n] += tiles[n]
    ok = all(set(c) == {80, 96} and all(all(x.values()) for x in c.values())
             for c in cover.values())
    log(f"backward tile classes run, per kernel and width: {cover} {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit("chip_smoke: the backward's cases miss a tile class at some width")
    return cover


def launch_counts() -> dict[str, int]:
    from aki_torch.ops.flash_mma import flash_mma_attention
    from aki_torch.ops.flash_mma_bwd import run_backward

    return {"fwd": flash_mma_attention.launches, "dq": run_backward.dq_launches,
            "dkv": run_backward.dkv_launches}


def zero_launch_counts() -> None:
    from aki_torch.ops.flash_mma import flash_mma_attention
    from aki_torch.ops.flash_mma_bwd import run_backward

    flash_mma_attention.launches = run_backward.dq_launches = run_backward.dkv_launches = 0


def whole_model_grads(cfg, batch) -> dict:
    """Phase 7: loss and gradients of one training batch at full width and
    depth, with the kernels against the plain attention."""
    from aki_torch.models.aki import AKIModel
    from aki_torch.models.common import BF16, F32
    from aki_torch.train.step import Batch, make_loss_fn

    model = AKIModel(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(3))
    model.vision_encoder.requires_grad_(False)
    dev_batch = Batch(*(torch.as_tensor(x).cuda() for x in (
        batch.input_ids, batch.images, batch.attn_valid, batch.labels)))
    lm = model.lang_model
    picks = {"layer0.qkv_proj": lm.model.layers[0].self_attn["qkv_proj"].weight,
             "layer31.o_proj": lm.model.layers[-1].self_attn["o_proj"].weight,
             "layer31.down_proj": lm.model.layers[-1].mlp["down_proj"].weight,
             "perceiver.latents": model.vision_tokenizer.latents,
             "lm_head": lm.lm_head.weight}
    runs = {}
    # the kernels and the plain attention in bf16, then the plain attention
    # with f32 compute on the same fp32 weights as the reference of both
    for name, use_flash, policy in (("kernel", True, BF16), ("plain", False, BF16),
                                    ("f32", False, F32)):
        model.zero_grad(set_to_none=True)
        loss_fn = make_loss_fn(cfg, policy, remat=True, use_flash=use_flash)
        zero_launch_counts()
        loss = loss_fn(model, dev_batch)
        loss.backward()
        torch.cuda.synchronize()
        runs[name] = dict(loss=loss.item(), launches=launch_counts(),
                          grads={k: p.grad.detach().float().clone() for k, p in picks.items()})
    del model, picks, loss
    kern, plain, f32 = runs["kernel"], runs["plain"], runs["f32"]

    def cos(a, b):
        return {k: torch.nn.functional.cosine_similarity(
            a["grads"][k].flatten(), b["grads"][k].flatten(), dim=0).item() for k in a["grads"]}
    cos_kp, cos_k32, cos_p32 = cos(kern, plain), cos(kern, f32), cos(plain, f32)
    rel = abs(kern["loss"] - plain["loss"]) / abs(plain["loss"])
    want = {"fwd": cfg.siglip.num_layers + 2 * cfg.phi3.num_layers,
            "dq": cfg.phi3.num_layers, "dkv": cfg.phi3.num_layers}
    log(f"whole-model grads: loss kernel={kern['loss']:.6f} plain={plain['loss']:.6f} "
        f"f32={f32['loss']:.6f} rel_diff={rel:.3g} (tol {LOSS_RTOL}); grad cosine kernel vs "
        f"plain (min {GRAD_COSINE_MIN}) " + " ".join(f"{k}={c:.6f}" for k, c in cos_kp.items())
        + "; to the f32 run kernel/plain " + " ".join(
            f"{k}={cos_k32[k]:.6f}/{cos_p32[k]:.6f}" for k in cos_kp)
        + f"; launches kernel run {kern['launches']} (want {want}), plain run "
        f"{plain['launches']}")
    del runs, kern["grads"], plain["grads"], f32["grads"]
    if not all(math.isfinite(r["loss"]) for r in (kern, plain, f32)):
        raise SystemExit("chip_smoke: non-finite whole-model loss")
    if rel > LOSS_RTOL or min(cos_kp.values()) < GRAD_COSINE_MIN or any(
            1 - cos_k32[k] > 2 * (1 - cos_p32[k]) + 1e-4 for k in cos_kp):
        raise SystemExit("chip_smoke: whole-model gradients with the kernels differ from plain")
    if kern["launches"] != want or plain["launches"]["dq"] or plain["launches"]["dkv"]:
        raise SystemExit("chip_smoke: whole-model step did not launch the kernels as expected")
    return dict(loss=kern["loss"], plain_loss=plain["loss"], f32_loss=f32["loss"],
                loss_rel_diff=rel, grad_cosine=cos_kp, grad_cosine_to_f32=cos_k32,
                plain_grad_cosine_to_f32=cos_p32, launches=kern["launches"])


def train_full_width(cfg, batches, t_full) -> dict:
    """Phase 8: the Trainer at full width, TRAIN_STEPS optimizer steps of
    grad_accum 2 over the same two micro-batches; each step is one
    ``run_epoch`` call over the two loader batches."""
    from aki_torch.train.metrics import MetricsLogger
    from aki_torch.train.runner import RunnerConfig, Trainer

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_dir = os.path.join(ROOT, "build", "chip_smoke_run")
    trainer = Trainer(cfg, RunnerConfig(
        run_dir=run_dir, precision="bf16", remat=True, frozen_bf16=True, grad_accum=2,
        warmup_steps=0, learning_rate=1e-4, total_steps=1000, checkpoint_steps=10**9,
        log_every=1, seed=4), device="cuda",
        metrics=MetricsLogger(run_dir, use_tensorboard=False))
    torch.cuda.synchronize()
    n_train = sum(p.numel() for p in trainer.state.optimizer.params)
    n_frozen = sum(p.numel() for n, p in trainer.model.named_parameters()
                   if n.startswith("vision_encoder."))
    log(f"trainer aki_4b: trainable_params={n_train} frozen_params={n_frozen} (bf16) "
        f"init_seconds={time.perf_counter() - t0:.1f} "
        f"memory_allocated_gb={torch.cuda.memory_allocated() / 1e9:.2f}")
    tokens = 2 * batches[0].input_ids.shape[0] * t_full
    steps = []
    for i in range(TRAIN_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        zero_launch_counts()
        start.record()
        trainer.run_epoch(iter(batches), epoch=0)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        rec = trainer.metrics.last
        steps.append(dict(step=rec["step"], loss=rec["training_loss"],
                          grad_norm=rec["grad_norm"], ms=ms, tokens_per_s=tokens / ms * 1e3,
                          launches=launch_counts()))
        log(f"train step {rec['step']}: loss={rec['training_loss']:.6f} "
            f"grad_norm={rec['grad_norm']:.6f} step_ms={ms:.1f} "
            f"tokens_per_s={tokens / ms * 1e3:.1f} (spliced tokens {tokens}) "
            f"launches={steps[-1]['launches']}")
    peak = torch.cuda.max_memory_allocated()
    log(f"train peak_memory_allocated_gb={peak / 1e9:.3f} ({peak} bytes)")

    # where the time goes in one step: the device's busy share and the
    # attention kernels' share of it
    profile_call("train_step", lambda: trainer.run_epoch(iter(batches), epoch=0), host=True)
    trainer.metrics.close()
    del trainer
    want = {"fwd": 2 * (cfg.siglip.num_layers + 2 * cfg.phi3.num_layers),
            "dq": 2 * cfg.phi3.num_layers, "dkv": 2 * cfg.phi3.num_layers}
    losses = [st["loss"] for st in steps]
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        raise SystemExit("chip_smoke: non-finite training loss")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"chip_smoke: training loss did not fall: {losses}")
    if any(st["launches"] != want for st in steps):
        raise SystemExit(f"chip_smoke: launches per train step differ from {want}")
    return dict(steps=steps, peak_bytes=peak, tokens_per_step=tokens)


FUSED_QUANT_REPLACES = {
    "rms": "aki_tpu/ops/fused_quant.py:66 (_rms_quant_kernel)",
    "ln": "aki_tpu/ops/fused_quant.py:73 (_ln_quant_kernel)",
    "silu": "aki_tpu/ops/fused_quant.py:83 (_silu_mul_quant_kernel)",
    "gelu": "aki_tpu/ops/fused_quant.py:89 (_gelu_quant_kernel)",
}
K4_REPLACES = ("aki_tpu/ops/decode_attention.py:70 (_kernel; wrapper decode_attention_flat "
               ":254, pallas_call :301)")


def fused_quant_fns(op):
    """(kernel wrapper, plain version) of one fused quantize op."""
    from aki_torch.ops import fused_quant as fq

    return {"rms": (fq.rmsnorm_quant, fq.rmsnorm_quant_reference),
            "ln": (fq.layernorm_quant, fq.layernorm_quant_reference),
            "silu": (fq.silu_mul_quant, fq.silu_mul_quant_reference),
            "gelu": (fq.gelu_quant, fq.gelu_quant_reference)}[op]


def int8_launch_counts() -> dict[str, int]:
    from aki_torch.ops.decode_attention import decode_attention_flat
    from aki_torch.ops.flash_mma import flash_mma_attention

    return {**{op: fused_quant_fns(op)[0].launches for op in FUSED_QUANT_REPLACES},
            "decode": decode_attention_flat.launches, "flash_fwd": flash_mma_attention.launches}


def zero_int8_launch_counts() -> None:
    from aki_torch.ops.decode_attention import decode_attention_flat
    from aki_torch.ops.flash_mma import flash_mma_attention

    for op in FUSED_QUANT_REPLACES:
        fused_quant_fns(op)[0].launches = 0
    decode_attention_flat.launches = flash_mma_attention.launches = 0


def kernel_ms(split: dict, part: str) -> float | None:
    """The device ms per call of the kernels in ``split`` (kernel_split_ms)
    whose name holds ``part``; None when the profiler saw none."""
    picked = [ms for name, ms in split.items() if part in name]
    return sum(picked) if picked else None


def kernel_timings(fn, part: str, cycling=None) -> dict:
    """Device ms per call of the kernels named ``part`` in ``fn``
    (torch.profiler over 10 calls): ``device_ms`` warm, ``cold_device_ms``
    with a FLUSH_BYTES write before each call, the launches the warm
    session saw of those issued, and ``ms``, the call by CUDA events
    (cuda_ms). With ``cycling`` (the same call walking the cache's layers
    in turn, as a decode step reads them) ``device_ms`` and ``layers_ms``
    are its times and the warm one is ``warm_device_ms``."""
    rec = {}
    if cycling is not None:
        rec["device_ms"] = kernel_ms(kernel_split_ms(cycling), part)
        rec["layers_ms"] = cuda_ms(cycling)
    rec["warm_device_ms" if cycling is not None else "device_ms"] = kernel_ms(
        kernel_split_ms(fn), part)
    rec["profiler_seen_of"] = profiler_shortfall(part)
    rec["cold_device_ms"] = kernel_ms(cold_split_ms(fn), part)
    rec["ms"] = cuda_ms(fn)
    return rec


def fused_quant_inputs(op, rows, d, gen, edge=False):
    """bf16 rows of one fused quantize op and its arguments; ``edge`` makes
    row 0 all zero and gives row 1 (when there is one) one huge value.
    silu*mul reads gate and up as the two halves of one (rows, 2d) product,
    as the decoder hands them over."""
    dev = "cuda"

    def bf(*shape, lo=None):
        x = torch.randn(*shape, device=dev, generator=gen)
        return (x if lo is None else x.abs() + lo).to(torch.bfloat16)

    x = bf(rows, 2 * d) if op == "silu" else bf(rows, d)
    if edge:
        x[0] = 0
        if rows > 1:
            x[1, 3] = 3e4
    if op == "silu":
        x, up = x.chunk(2, dim=-1)
    return {"rms": lambda: (x, bf(d, lo=0.5), 1e-5),
            "ln": lambda: (x, bf(d, lo=0.5), bf(d) * 0.1, 1e-6),
            "silu": lambda: (x, up),
            "gelu": lambda: (x, bf(d) * 0.1)}[op]()


def fused_quant_bound(op, rows, d) -> tuple[float, str, int, int]:
    """(bound ms, by, FLOPs, bytes) of one fused quantize launch: each input
    row and vector read once, q and s written once."""
    n_vec = {"rms": 1, "ln": 2, "silu": 0, "gelu": 1}[op]
    n_rows_in = 2 if op == "silu" else 1
    nbytes = rows * d * 2 * n_rows_in + n_vec * d * 2 + rows * d + rows * 4
    flops = QUANT_OPS_PER_VALUE[op] * rows * d
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def fused_quant_case(op, rows, d, gen, edge=False, timed=False) -> dict:
    """Phase 9: one fused quantize kernel against its plain version on bf16
    rows (fused_quant_inputs), its launch plan held to the mirror
    (fused_quant.row_plan) and every row written; ``timed`` adds the
    kernel's device times warm and cold (kernel_timings) and the plain
    version's beside the bound."""
    from aki_torch.ops import fused_quant as fq

    fn, ref = fused_quant_fns(op)
    args = fused_quant_inputs(op, rows, d, gen, edge)
    with time_limit(f"fused quant {op} rows={rows} d={d}", BWD_CASE_SECONDS):
        got = fn(*args)
        torch.cuda.synchronize()
    want = ref(*args)
    dq = (got[0].int() - want[0].int()).abs()
    srel = ((got[1] - want[1]).abs() / want[1]).max().item()
    plan = fq.kernel_plan(op, rows, d)
    mirror = fq.row_plan(op, rows, d, torch.cuda.get_device_properties(0).multi_processor_count,
                         plan[3])
    ok = (got[0].dtype == torch.int8 and got[1].shape == (rows, 1)
          and dq.max().item() <= QUANT_STEP_MAX and srel <= QUANT_SCALE_RTOL
          and tuple(plan[:3]) == mirror)
    if edge and op in ("rms", "silu"):
        # an all-zero row quantizes to zeros with scale 1 (ln and gelu add a bias)
        ok = ok and bool((got[0][0] == 0).all()) and got[1][0].item() == 1.0
    team, tpb, blocks, per_sm, stages = plan
    rec = dict(name=op, rows=rows, d=d, edge=edge, max_abs_err=dq.max().item(),
               frac_one_step=(dq > 0).float().mean().item(), scale_max_rel_err=srel,
               plan=dict(warps_per_row=team, teams_per_block=tpb, blocks=blocks,
                         blocks_per_sm=per_sm, ring_stages=stages,
                         rows_per_team_max=-(-rows // (blocks * tpb))))
    log(f"fused quant {op} rows={rows} d={d} edge={edge}: max |q_kernel - q_plain|="
        f"{rec['max_abs_err']} (max {QUANT_STEP_MAX}) fraction one step off="
        f"{rec['frac_one_step']:.3g} scale max rel err={srel:.3g} (max {QUANT_SCALE_RTOL}) "
        f"plan {rec['plan']} (mirror {mirror}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(f"chip_smoke: fused quant kernel {op} disagrees with the plain version")
    if timed:
        bound_ms, by, flops, nbytes = fused_quant_bound(op, rows, d)
        rec.update(kernel_timings(lambda: fn(*args), "fused_quant"))
        rec.update(plain_ms=cuda_ms(lambda: ref(*args), reps=5), library_ms=None,
                   bound_ms=bound_ms, bound_by=by, bound_flops=flops, bound_bytes=nbytes)
        log(f"  fused quant {op} rows={rows} d={d} " + " ".join(
            f"{key}={rec[key]}" for key in ("ms", "device_ms", "cold_device_ms",
                                            "profiler_seen_of", "plain_ms", "bound_ms",
                                            "bound_by", "bound_bytes")))
    return rec


def decode_f32(q, k, ks, v, vs, lengths, layer, live_width=None):
    """Attention in f32 over the dequantized cache (k * ks, v * vs), with
    nothing rounded to bf16: the f32 reference of the decode kernel."""
    b, _, h, d = q.shape
    s_len, hkv = ks.shape[2], ks.shape[3]
    rows = b if live_width is None else min(live_width, b)
    group = h // hkv
    kd = (k[layer, :rows].float().view(rows, s_len, hkv, d)
          * ks[layer, :rows, :, :, None]).repeat_interleave(group, dim=2)
    vd = (v[layer, :rows].float().view(rows, s_len, hkv, d)
          * vs[layer, :rows, :, :, None]).repeat_interleave(group, dim=2)
    sc = torch.einsum("bhd,bshd->bhs", q[:rows, 0].float(), kd) * d ** -0.5
    ok = torch.arange(s_len, device=q.device)[None, None] < lengths[:rows, None, None]
    p = torch.softmax(sc.masked_fill(~ok, float("-inf")), dim=-1).nan_to_num(0.0)
    out = torch.zeros(b, 1, h, d, device=q.device)
    out[:rows, 0] = torch.einsum("bhs,bshd->bhd", p, vd)
    return out


def decode_inputs(n_layers, b, s_len, h, hkv, d, gen):
    """A random int8 cache with its scales and a bf16 query: (q, k, ks, v, vs)."""
    dev = "cuda"
    shape, sshape = (n_layers, b, s_len, hkv * d), (n_layers, b, s_len, hkv)
    k = torch.randint(-127, 128, shape, device=dev, generator=gen, dtype=torch.int8)
    v = torch.randint(-127, 128, shape, device=dev, generator=gen, dtype=torch.int8)
    ks = torch.rand(sshape, device=dev, generator=gen) * 0.02 + 1e-3
    vs = torch.rand(sshape, device=dev, generator=gen) * 0.02 + 1e-3
    q = torch.randn(b, 1, h, d, device=dev, generator=gen).to(torch.bfloat16)
    return q, k, ks, v, vs


def decode_gates(got, want, exact, lens, live_width) -> dict:
    """The decode kernel's output against the plain version's, element-wise
    (ATOL + RTOL of each), and against attention in f32 over the
    dequantized cache (mean |error| within F32_ERR_RATIO of the plain
    version's); rows past ``live_width`` and rows of length 0 must be 0."""
    rows = got.shape[0] if live_width is None else live_width
    diff = (got.float() - want.float()).abs()
    k_err = (got.float() - exact)[:rows].abs().mean().item()
    p_err = (want.float() - exact)[:rows].abs().mean().item()
    dead = torch.cat([got[rows:].flatten(), got[:rows][lens[:rows] == 0].flatten()])
    dead_zero = bool((dead == 0).all())
    ok = (bool(torch.isfinite(got).all())
          and bool((diff <= ATOL + RTOL * want.float().abs()).all())
          and k_err <= F32_ERR_RATIO * p_err + 1e-7 and dead_zero)
    return dict(ok=ok, max_abs_err=diff.max().item(), mean_abs_err_vs_f32=k_err,
                plain_mean_abs_err_vs_f32=p_err, dead_rows_zero=dead_zero)


def decode_work(lens, rows, b, s_len, h, hkv, d) -> tuple[int, int]:
    """(FLOPs, bytes) of one decode launch: 4*d per (query head, live key)
    for QK and PV; each live key's K and V rows and scales read once, q
    read and the output written once."""
    live = sum(min(max(n, 0), s_len) for n in lens[:rows])
    return (4 * d * h * live,
            live * (2 * hkv * d + 2 * 4 * hkv) + rows * h * d * 2 + b * h * d * 2 + b * 4)


def decode_times(q, k, ks, v, vs, lens_t, lens_l, live_width=None, layer=1) -> dict:
    """The decode kernel's times on one cache: kernel_timings at ``layer``
    (warm: the same layer again and again; cold: after a 64 MB write) and
    over the layers in turn (a decode step's reads; each layer of a
    one-request cache fits the L2, all of them do not), the plain version
    by CUDA events, and the bound."""
    import itertools

    from aki_torch.ops.decode_attention import (decode_attention_flat,
                                                decode_attention_flat_reference)

    n_layers, b, s_len, hkv = ks.shape
    h, d = q.shape[2], q.shape[3]
    rows = b if live_width is None else live_width
    turn = itertools.count()
    rec = kernel_timings(
        lambda: decode_attention_flat(q, k, ks, v, vs, lens_t, layer, live_width=live_width),
        "decode_attention",
        cycling=lambda: decode_attention_flat(q, k, ks, v, vs, lens_t, next(turn) % n_layers,
                                              live_width=live_width))
    w = decode_work(lens_l, rows, b, s_len, h, hkv, d)
    t_ops, t_bytes = w[0] / PEAK_BF16_FLOPS * 1e3, w[1] / PEAK_HBM_BYTES * 1e3
    rec.update(plain_ms=cuda_ms(lambda: decode_attention_flat_reference(
        q, k, ks, v, vs, lens_t, layer, live_width=live_width), reps=5),
        library_ms=None, bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes", bound_flops=w[0],
        bound_bytes=w[1])
    return rec


def decode_case(name, n_layers, b, s_len, h, hkv, d, lengths, layers, gen, live_width=None,
                timed=None) -> dict:
    """Phase 10: the int8-KV decode kernel against its plain version on one
    random cache, at each of ``layers`` (decode_gates), with the cluster
    size the wrapper picks; ``timed`` maps labels to lengths to time at
    (decode_times)."""
    from aki_torch.ops import decode_attention as da

    q, k, ks, v, vs = decode_inputs(n_layers, b, s_len, h, hkv, d, gen)
    lens = torch.tensor(lengths, device="cuda", dtype=torch.int32)
    rows = b if live_width is None else live_width
    cluster = da.cluster_size(rows * h, da._sm_count(q.device), s_len, d)
    smem = da._kernel_lib().decode_attention_smem_bytes(s_len, cluster, d)
    if smem != da.smem_bytes(s_len, cluster, d):
        raise SystemExit(f"chip_smoke: decode_attention.cu sizes {smem} bytes of shared memory, "
                         f"its mirror {da.smem_bytes(s_len, cluster, d)}")
    rec = dict(name=name, cache=list(k.shape), heads=[h, hkv, d], live_width=live_width,
               lengths=lengths, cluster=cluster, smem_bytes=smem, layers=[])
    for layer in layers:
        with time_limit(f"decode {name} layer {layer}", BWD_CASE_SECONDS):
            got = da.decode_attention_flat(q, k, ks, v, vs, lens, layer, live_width=live_width)
            torch.cuda.synchronize()
        want = da.decode_attention_flat_reference(q, k, ks, v, vs, lens, layer,
                                                  live_width=live_width)
        gate = decode_gates(got, want, decode_f32(q, k, ks, v, vs, lens, layer, live_width),
                            lens, live_width)
        rec["layers"].append(dict(layer=layer, **gate))
        log(f"decode {name} layer {layer}: q={tuple(q.shape)} cache={tuple(k.shape)} "
            f"live_width={live_width} cluster={cluster} max_abs_err={gate['max_abs_err']:.4g} "
            f"(tol |d|<={ATOL}+{RTOL}*|plain|); mean |err| vs f32 kernel "
            f"{gate['mean_abs_err_vs_f32']:.4g} plain {gate['plain_mean_abs_err_vs_f32']:.4g} "
            f"(kernel <= {F32_ERR_RATIO}x plain); dead rows zero {gate['dead_rows_zero']} "
            f"{'ok' if gate['ok'] else 'FAILED'}")
        if not gate["ok"]:
            raise SystemExit(f"chip_smoke: decode kernel case {name} disagrees with plain")
    rec["max_abs_err"] = max(r["max_abs_err"] for r in rec["layers"])
    for label, lens_l in (timed or {}).items():
        lens_t = torch.tensor(lens_l, device="cuda", dtype=torch.int32)
        with time_limit(f"decode {name} {label} timings", BWD_TIMING_SECONDS):
            rec[label] = decode_times(q, k, ks, v, vs, lens_t, lens_l, live_width)
        log(f"  decode {name} {label} lengths: " + " ".join(
            f"{key}={val}" for key, val in rec[label].items()))
    return rec


def fused_quant_phase(cfg, gen) -> dict[str, list]:
    """Phase 9: each fused quantize kernel at the W8A8 serving prefill's
    shape and at the one-request prefills of phase 11 (quant_timing_shapes),
    timed; then edge cases: 1 row, 7 rows, 1101 rows (a block part empty),
    and 7 rows at each of QUANT_EDGE_WIDTHS, all but 1 row with edge rows."""
    fq_cases = {op: [] for op in FUSED_QUANT_REPLACES}
    for op, rows, d in quant_timing_shapes(cfg):
        fq_cases[op].append(fused_quant_case(op, rows, d, gen, edge=True, timed=True))
        free_cuda()
    for op, cases_op in fq_cases.items():
        d = cases_op[0]["d"]
        cases_op += [fused_quant_case(op, 1, d, gen),
                     *(fused_quant_case(op, n, d, gen, edge=True) for n in (7, 1101)),
                     *(fused_quant_case(op, 7, w, gen, edge=True) for w in QUANT_EDGE_WIDTHS
                       if w != d)]
        free_cuda()
    return fq_cases


def decode_phase(cfg, prompts, gen) -> list[dict]:
    """Phase 10: the int8-KV decode kernel at the serving cache (timed full
    and ragged), below its live width, GQA 32/8, at phase 11's one-request
    caches at the first and the last decode step's lengths (the spliced
    prompt plus 1 and plus NEW_TOKENS; the last timed), and at every cluster
    size the wrapper picks, on lengths at the edges of the split."""
    ph = cfg.phi3
    dec_cases = [decode_case("serving", ph.num_layers, SERVE_SLOTS, SERVE_MAX_LEN, ph.num_heads,
                             ph.num_kv_heads, ph.head_dim, SERVE_RAGGED,
                             (0, ph.num_layers - 1), gen,
                             timed={"full": [SERVE_MAX_LEN] * SERVE_SLOTS,
                                    "ragged": SERVE_RAGGED})]
    free_cuda()
    dec_cases.append(decode_case("serving_live_width", ph.num_layers, SERVE_SLOTS,
                                 SERVE_MAX_LEN, ph.num_heads, ph.num_kv_heads, ph.head_dim,
                                 SERVE_RAGGED, (ph.num_layers - 1,), gen,
                                 live_width=SERVE_SLOTS // 2))
    free_cuda()
    dec_cases.append(decode_case("gqa_h32_hkv8", 2, 4, 300, 32, 8, ph.head_dim,
                                 [1, 100, 300, 0], (0, 1), gen))
    free_cuda()
    for r in prompts:
        for n in (r["t_full"] + 1, r["t_full"] + NEW_TOKENS):
            last = n > r["t_full"] + 1
            dec_cases.append(decode_case(
                f"generate_{r['name']}_len{n}", ph.num_layers, 1, r["max_len"], ph.num_heads,
                ph.num_kv_heads, ph.head_dim, [n], (0, ph.num_layers - 1), gen,
                timed={"at_length": [n]} if last else None))
            free_cuda()
    dec_cases += decode_cluster_edges(ph, gen)
    picked = sorted({c["cluster"] for c in dec_cases})
    log(f"decode cluster sizes picked: {picked}")
    if picked != list(CLUSTER_SIZES_WANT):
        raise SystemExit(f"chip_smoke: the decode cases ran clusters {picked}, not "
                         f"{CLUSTER_SIZES_WANT}")
    return dec_cases


def decode_cluster_edges(ph, gen) -> list[dict]:
    """Phase 10's split edges: for each cluster size C the wrapper can pick,
    the fewest rows of the serving cache's width that make it pick C, with
    lengths 0, 1, C - 1, C + 1, 64 C + 1 (one key past a 64-key tile in
    each block's share), S - 1 and S spread over those rows, at the first
    and the last layer."""
    from aki_torch.ops import decode_attention as da

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    h, hkv, d, s_len = ph.num_heads, ph.num_kv_heads, ph.head_dim, SERVE_MAX_LEN
    cases = []
    for c in da.CLUSTER_SIZES:
        b = next(b for b in range(1, 65) if da.cluster_size(b * h, sms, s_len, d) == c)
        lens = [0, 1, c - 1, c + 1, 64 * c + 1, s_len - 1, s_len]
        for i in range(0, len(lens), b):
            part = [lens[(i + j) % len(lens)] for j in range(b)]
            cases.append(decode_case(f"cluster{c}_rows{b}_{i // b}", ph.num_layers, b, s_len,
                                     h, hkv, d, part, (0, ph.num_layers - 1), gen))
            free_cuda()
    return cases


def decode_timing_cases(gen, one_row_lengths) -> list[dict]:
    """The inputs of decode_ab.py's cases, at phase 10's timed shapes: the
    serving cache with every row full and with ragged lengths (one cache),
    and one row of each one-request cache ((max_len, length) pairs) at its
    last decode length; each with the plain and f32 outputs at layer 1 and
    the bound."""
    from aki_torch.models.configs import aki_4b
    from aki_torch.ops.decode_attention import decode_attention_flat_reference

    ph = aki_4b().phi3
    serving = decode_inputs(ph.num_layers, SERVE_SLOTS, SERVE_MAX_LEN, ph.num_heads,
                            ph.num_kv_heads, ph.head_dim, gen)
    specs = [("full", serving, [SERVE_MAX_LEN] * SERVE_SLOTS),
             ("ragged", serving, SERVE_RAGGED)]
    for s_len, n in one_row_lengths:
        specs.append((f"one_row_{s_len}_len{n}",
                      decode_inputs(ph.num_layers, 1, s_len, ph.num_heads, ph.num_kv_heads,
                                    ph.head_dim, gen), [n]))
    cases = []
    for name, (q, k, ks, v, vs), lens_l in specs:
        lens = torch.tensor(lens_l, device="cuda", dtype=torch.int32)
        b, s_len = k.shape[1], k.shape[2]
        w = decode_work(lens_l, b, b, s_len, ph.num_heads, ph.num_kv_heads, ph.head_dim)
        cases.append(dict(name=name, tensors=(q, k, ks, v, vs, lens), layer=1,
                          plain=decode_attention_flat_reference(q, k, ks, v, vs, lens, 1),
                          f32=decode_f32(q, k, ks, v, vs, lens, 1),
                          bound=dict(ms=max(w[0] / PEAK_BF16_FLOPS, w[1] / PEAK_HBM_BYTES) * 1e3,
                                     flops=w[0], bytes=w[1])))
    return cases


def logit_drift(a: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """Mean and largest |a - ref| over the standard deviation of ``ref``."""
    d, sd = (a.float() - ref.float()).abs(), ref.float().std()
    return (d.mean() / sd).item(), (d.max() / sd).item()


def int8_generation(cfg, prompts) -> tuple:
    """Phase 11: aki_4b() quantized W8A8 (tower included) with the int8 KV
    cache. Request a's last-position prefill logits against the bf16 and f32
    runs of the same weights, then NEW_TOKENS greedy tokens for each request
    with the launches of each call; returns (the quantized model, record)."""
    from aki_torch.infer.engine import decode_step, generate, prefill
    from aki_torch.models.aki import AKIModel
    from aki_torch.models.common import F32
    from aki_torch.models.quant import quantize_params

    t0 = time.perf_counter()
    model = AKIModel(cfg, device="cuda", dtype=torch.bfloat16,
                     generator=torch.Generator(device="cuda").manual_seed(0))
    model.requires_grad_(False)
    a = prompts[0]
    args = (a["ids"], a["image"], a["valid"], a["max_len"])
    bf16_logits = prefill(model, *args).last_logits
    model.float()
    f32_logits = prefill(model, *args, policy=F32, use_flash=False).last_logits
    model.bfloat16()                      # bf16-born weights: the round trip is exact
    free_cuda()
    quantize_params(model, mode="w8a8", vision=True)
    free_cuda()
    torch.cuda.synchronize()
    log(f"int8 model: quantized in {time.perf_counter() - t0:.1f} s (with the bf16 and f32 "
        f"reference prefills); memory_allocated_gb={torch.cuda.memory_allocated() / 1e9:.3f}")
    n_tower, n_dec = cfg.siglip.num_layers, cfg.phi3.num_layers
    per_prefill = {"ln": 2 * n_tower, "gelu": n_tower, "rms": 2 * n_dec, "silu": n_dec}

    zero_int8_launch_counts()
    int8_logits = prefill(model, *args, kv_int8=True).last_logits
    torch.cuda.synchronize()
    counts = int8_launch_counts()
    cosine = lambda x, y: torch.nn.functional.cosine_similarity(  # noqa: E731
        x.float(), y.float(), dim=-1).item()
    d_bf16, d_f32, d_ref = (logit_drift(int8_logits, bf16_logits),
                            logit_drift(int8_logits, f32_logits),
                            logit_drift(bf16_logits, f32_logits))
    rec = dict(prefill_logits=dict(
        drift_vs_bf16=d_bf16, drift_vs_f32=d_f32, bf16_drift_vs_f32=d_ref,
        cosine_vs_bf16=cosine(int8_logits, bf16_logits),
        cosine_vs_f32=cosine(int8_logits, f32_logits),
        bf16_cosine_vs_f32=cosine(bf16_logits, f32_logits),
        argmax_equal_bf16=bool((int8_logits.argmax(-1) == bf16_logits.argmax(-1)).all()),
        launches=counts))
    log("int8 prefill logits (request a): " + " ".join(
        f"{k_}={v_}" for k_, v_ in rec["prefill_logits"].items())
        + f"; gate: mean drift < {DRIFT_MEAN_MAX} and max drift < {DRIFT_MAX_MAX} of the "
        "reference's std, against bf16 and against f32")
    if not all(torch.isfinite(x).all() for x in (bf16_logits, f32_logits, int8_logits)):
        raise SystemExit("chip_smoke: non-finite int8 prefill logits")
    if any(dm >= DRIFT_MEAN_MAX or dx >= DRIFT_MAX_MAX for dm, dx in (d_bf16, d_f32)):
        raise SystemExit("chip_smoke: int8 prefill logits drift past the gate")
    if {op: counts[op] for op in per_prefill} != per_prefill or counts["decode"] or \
            counts["flash_fwd"]:
        raise SystemExit(f"chip_smoke: int8 prefill launches {counts}, want {per_prefill}")
    del bf16_logits, f32_logits, int8_logits

    torch.cuda.reset_peak_memory_stats()
    rec["requests"] = []
    for r in prompts:
        generate(model, r["ids"], r["image"], r["valid"], 2, r["max_len"], kv_int8=True)
        torch.cuda.synchronize()
        start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        zero_int8_launch_counts()
        t0 = time.perf_counter()
        start.record()
        tokens, num = generate(model, r["ids"], r["image"], r["valid"], NEW_TOKENS,
                               r["max_len"], kv_int8=True, on_prefill=mid.record)
        end.record()
        end.synchronize()
        gen_ms = (time.perf_counter() - t0) * 1e3
        counts = int8_launch_counts()
        want = {**per_prefill, "decode": n_dec * NEW_TOKENS, "flash_fwd": 0}
        toks = tokens[0].tolist()
        rr = dict(name=r["name"], spliced=r["t_full"], max_len=r["max_len"],
                  prefill_ms=start.elapsed_time(mid),
                  decode_ms_per_token=mid.elapsed_time(end) / NEW_TOKENS,
                  generate_ms=gen_ms, launches=counts, tokens=toks)
        rec["requests"].append(rr)
        log(f"int8 generate {r['name']}: spliced={r['t_full']} max_len={r['max_len']} "
            f"prefill_ms={rr['prefill_ms']:.2f} decode_ms_per_token="
            f"{rr['decode_ms_per_token']:.3f} generate_ms={gen_ms:.1f} launches={counts} "
            f"(want {want}) tokens={toks}")
        if counts != want:
            raise SystemExit(f"chip_smoke: int8 generate launches {counts}, want {want}")
        if tokens.shape != (1, NEW_TOKENS) or int(num[0]) != NEW_TOKENS or not all(
                0 <= x < cfg.output_vocab for x in toks):
            raise SystemExit("chip_smoke: int8 generated tokens out of shape or range")
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"int8 generate peak_memory_allocated_gb={rec['peak_bytes'] / 1e9:.3f}")
    for r in prompts:
        pargs = (r["ids"], r["image"], r["valid"], r["max_len"])
        profile_call(f"int8_prefill_{r['name']}", lambda: prefill(model, *pargs, kv_int8=True))
        state = prefill(model, *pargs, kv_int8=True)
        profile_call(f"int8_decode_step_{r['name']}",
                     lambda: decode_step(model, state, state.last_logits.argmax(-1)))
        del state
    return model, rec


def serving_prompts(cfg, n: int) -> list[tuple]:
    """The drain's traffic, as the JAX package's bench.py draws it: n prompts
    of 256-511 text tokens with <image> at 1 and <|assistant|> at 40, one
    uint8 384x384 image each, and budgets of 8-32 new tokens."""
    import numpy as np

    rng = np.random.RandomState(1)
    s = cfg.siglip.image_size
    out = []
    for _ in range(n):
        m = int(rng.randint(SERVE_BUCKET // 2, SERVE_BUCKET))
        ids = rng.randint(5, cfg.initial_tokenizer_len - 1, size=m)
        ids[1] = cfg.media_token_id
        ids[40] = cfg.assistant_token_id
        px = rng.randint(0, 256, (s, s, 3)).astype(np.uint8)
        out.append((ids.tolist(), px, int(rng.randint(8, 33))))
    return out


def prefill_attention_times(cfg, gen) -> dict:
    """The bf16-probability attentions of the int8 prefill against the flash
    kernel at the serving prefill shapes (48 rows of 655 decoder tokens under
    an MMA block, 48 images of 729 patches)."""
    from aki_torch.ops.attention import decoder_attention_bf16p, encoder_attention_bf16p
    from aki_torch.ops.flash_mma import flash_mma_attention
    from aki_torch.ops.masks import MMASpec

    ph, sg, dev = cfg.phi3, cfg.siglip, "cuda"
    n_vis = cfg.perceiver.num_latents
    b, t = SERVE_SLOTS, SERVE_BUCKET + n_vis - 1
    out = {}
    q, k, v = (torch.randn(b, t, ph.num_heads, ph.head_dim, device=dev,
                           generator=gen).to(torch.bfloat16) for _ in range(3))
    # <image> at 1, <|assistant|> at 40: the rectangle bench.py's prompts give
    spec = MMASpec(*(torch.full((b,), x, dtype=torch.int32, device=dev)
                     for x in (1, 1 + n_vis, 41 + n_vis - 1)))
    valid = torch.ones((b, t), dtype=torch.int32, device=dev)
    kw = dict(spec=spec, kv_valid=valid)
    out["decoder"] = dict(shape=[b, t, t, ph.num_heads, ph.head_dim],
                          bf16p_ms=cuda_ms(lambda: decoder_attention_bf16p(q, k, v, **kw), reps=5),
                          flash_ms=cuda_ms(lambda: flash_mma_attention(q, k, v, **kw), reps=5))
    del q, k, v
    free_cuda()
    t = sg.num_patches
    q, k, v = (torch.randn(b, t, sg.num_heads, sg.head_dim, device=dev,
                           generator=gen).to(torch.bfloat16) for _ in range(3))
    out["tower"] = dict(shape=[b, t, t, sg.num_heads, sg.head_dim],
                        bf16p_ms=cuda_ms(lambda: encoder_attention_bf16p(q, k, v), reps=5),
                        flash_ms=cuda_ms(lambda: flash_mma_attention(q, k, v, causal=False),
                                         reps=5))
    del q, k, v
    free_cuda()
    log(f"prefill attention at the serving shapes, bf16 probabilities vs the flash kernel: {out}")
    return out


def serve_drain(cfg, model) -> dict:
    """Phase 12: the serving engine in the bench.py configuration drains
    SERVE_REQUESTS requests under torch.profiler (device activity only);
    every request must complete with its budget, and the tokens of the
    first SERVE_FIRST_TOKEN_CHECKS requests are held to the one-shot path
    on the same weights: at least SERVE_FIRST_TOKEN_MIN first tokens equal
    to a one-shot generate's, and every token within the teacher-forced
    gap gate (see SERVE_GAP_FACTOR)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aki_torch.infer.engine import decode_step, generate, prefill
    from aki_torch.infer.server import ServingEngine

    eng = ServingEngine(model, num_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                        prompt_bucket=SERVE_BUCKET, admit_batch=SERVE_SLOTS,
                        admit_policy="batched", decode_chunk=8, kv_int8=True,
                        image_uint8=True, compact_tail=True, upload_chunk=16)
    try:
        t0 = time.perf_counter()
        eng.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        traffic = serving_prompts(cfg, SERVE_REQUESTS)
        eng.dispatch_log.clear()
        eng.decode_dispatches = 0
        zero_int8_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            reqs = [eng.submit(ids, px, max_new_tokens=m) for ids, px, m in traffic]
            eng.run_until_drained()
            torch.cuda.synchronize()
            drain_s = time.perf_counter() - t0
        counts = int8_launch_counts()
        peak = torch.cuda.max_memory_allocated()
        results = [r.result(timeout=60) for r in reqs]
        t_parse = time.perf_counter()
        busy, seen = {}, {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not e.name.startswith("Memcpy"):
                busy[e.name] = busy.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
                seen[e.name] = seen.get(e.name, 0) + 1
        busy_ms = sum(busy.values())
        parse_s = time.perf_counter() - t_parse
        n_prefill = sum(1 for kind, _, _ in eng.dispatch_log if kind == "prefill")
        n_dec = cfg.phi3.num_layers
        want = {"ln": 2 * cfg.siglip.num_layers * n_prefill,
                "gelu": cfg.siglip.num_layers * n_prefill, "rms": 2 * n_dec * n_prefill,
                "silu": n_dec * n_prefill, "decode": n_dec * 8 * eng.decode_dispatches,
                "flash_fwd": 0}
        n_tokens = sum(m for _, _, m in traffic)
        share = lambda name: sum(v_ for k_, v_ in busy.items() if name in k_)  # noqa: E731
        n_seen = lambda name: sum(v_ for k_, v_ in seen.items() if name in k_)  # noqa: E731
        # K4's and K5's launches the profiler saw of those issued, and their
        # device ms per drain as the mean of a seen launch times the issued
        port = {}
        for kname, issued in (("decode_attention_kernel", counts["decode"]),
                              ("fused_quant_kernel", sum(counts[op] for op in
                                                         FUSED_QUANT_REPLACES))):
            got = n_seen(kname)
            port[kname] = dict(seen=got, issued=issued, seen_ms=share(kname),
                               ms_per_drain=share(kname) / got * issued if got else None)
        rec = dict(requests=SERVE_REQUESTS, warmup_s=warm_s, drain_s=drain_s,
                   requests_per_s=SERVE_REQUESTS / drain_s, tokens=n_tokens,
                   tokens_per_s=n_tokens / drain_s, device_busy_ms=busy_ms,
                   idle_share=1 - busy_ms / (drain_s * 1e3), peak_bytes=peak,
                   prefill_dispatches=n_prefill, decode_dispatches=eng.decode_dispatches,
                   launches=counts, decode_kernel_ms=share("decode_attention_kernel"),
                   fused_quant_kernel_ms=share("fused_quant_kernel"), port_kernels=port,
                   profile_parse_s=parse_s,
                   top=sorted(((k_[:60], v_) for k_, v_ in busy.items()),
                              key=lambda kv: -kv[1])[:6])
        log("serve drain: " + " ".join(f"{k_}={v_}" for k_, v_ in rec.items()))
        bad = [i for i, (res, (_, _, m)) in enumerate(zip(results, traffic)) if len(res) != m]
        if bad:
            raise SystemExit(f"chip_smoke: requests {bad} did not complete with their budget")
        if counts != want:
            raise SystemExit(f"chip_smoke: drain launches {counts}, want {want}")
        # the server's tokens against the one-shot path of the same request:
        # the drift of its logits in a batched prefill of the checked
        # requests (padded to the bucket, as the server admits them), a
        # one-shot generate, and the one-shot path fed the served tokens
        n = SERVE_FIRST_TOKEN_CHECKS
        imgs = torch.stack([torch.from_numpy(px) for _, px, _ in traffic[:n]]).cuda()
        imgs = imgs.float() / 127.5 - 1.0
        ids_b = torch.full((n, SERVE_BUCKET), cfg.pad_token_id, dtype=torch.int32)
        valid_b = torch.zeros_like(ids_b)
        for i, (ids, _, _) in enumerate(traffic[:n]):
            ids_b[i, :len(ids)] = torch.tensor(ids)
            valid_b[i, :len(ids)] = 1
        batched = prefill(model, ids_b, imgs, valid_b, SERVE_MAX_LEN, kv_int8=True).last_logits
        checks = []
        for i, (ids, _, m) in enumerate(traffic[:n]):
            ids_t = torch.tensor([ids], dtype=torch.int32)
            args = (ids_t, imgs[i:i + 1], torch.ones_like(ids_t))
            state = prefill(model, *args, SERVE_MAX_LEN, kv_int8=True)
            drift = logit_drift(batched[i], state.last_logits[0])
            one, _ = generate(model, *args, m, SERVE_MAX_LEN, kv_int8=True)
            one = one[0].tolist()
            served = results[i]
            # teacher forcing: at each position, the one-shot's logits given
            # the served tokens before it
            gaps, margins = [], []
            for pos, tok in enumerate(served):
                o = state.last_logits[0]
                top2, sd = o.topk(2).values, o.std()
                gaps.append(((top2[0] - o[tok]) / sd).item())
                margins.append(((top2[0] - top2[1]) / sd).item())
                if pos + 1 < len(served):
                    state = decode_step(model, state, torch.tensor([tok], device="cuda"))
            del state
            first_diff = next((j for j, (x, y) in enumerate(zip(one, served)) if x != y), None)
            checks.append(dict(
                request=i, budget=m, first_equal=one[0] == served[0],
                later_equal=sum(x == y for x, y in zip(one[1:], served[1:])), later=m - 1,
                first_difference=first_diff, batched_drift=drift,
                top2_margin_over_std=margins[0],
                margin_at_first_difference=None if first_diff is None else margins[first_diff],
                served_equal_argmax=sum(g == 0.0 for g in gaps), max_gap_over_std=max(gaps),
                gap_at=gaps.index(max(gaps))))
        rec["one_shot_checks"] = checks
        n_equal = sum(c["first_equal"] for c in checks)
        delta = max(c["batched_drift"][1] for c in checks)
        gap_max = SERVE_GAP_FACTOR * delta
        rec["one_shot_gate"] = dict(first_equal=n_equal, delta_over_std=delta,
                                    gap_max_over_std=gap_max)
        log(f"serve drain vs one-shot: first tokens equal to generate's {n_equal} of {n} (min "
            f"{SERVE_FIRST_TOKEN_MIN}); teacher-forced, the one-shot's best logit leads each "
            f"served token by at most {max(c['max_gap_over_std'] for c in checks):.4g} std "
            f"(max {SERVE_GAP_FACTOR} x delta {delta:.4g} = {gap_max:.4g}): {checks}")
        if n_equal < SERVE_FIRST_TOKEN_MIN:
            raise SystemExit("chip_smoke: served first tokens differ from one-shot generate")
        if any(c["max_gap_over_std"] > gap_max for c in checks):
            raise SystemExit("chip_smoke: a served token trails the one-shot path's best logit "
                             "by more than batching can move it")
        return rec
    finally:
        eng.close()


K6_REPLACES = ("aki_tpu/ops/flash_mma.py:246 (_kernel_1kv_flat; wrapper "
               "flash_mma_attention_flat :301, pallas_call :363)")
K7_REPLACES = ("aki_tpu/ops/flash_mma.py:393 (_kernel_1kv_q8; wrapper "
               "flash_mma_attention_q8 :468, pallas_call :538)")
FLAT_DP = 128


def pad_heads(x: torch.Tensor, rope_halves: bool) -> torch.Tensor:
    """(B, T, H, D) -> the flat padded-head layout (B, T, H*128): q and k
    with their rope halves at lanes [0, D/2) and [64, 64 + D/2) of each
    head (the serving layout of quant.py:pad_attention_heads), v at [0, D);
    zeros elsewhere."""
    b, t, h, d = x.shape
    out = x.new_zeros(b, t, h, FLAT_DP)
    if rope_halves:
        out[..., :d // 2] = x[..., :d // 2]
        out[..., FLAT_DP // 2:FLAT_DP // 2 + d // 2] = x[..., d // 2:]
    else:
        out[..., :d] = x
    return out.reshape(b, t, h * FLAT_DP)


def serving_lengths(cfg) -> list[int]:
    """Spliced lengths of one admission of the drain's prompts (phase 12's
    draw): 48 rows of 256-511 text tokens plus 143."""
    return [len(ids) + cfg.perceiver.num_latents - 1
            for ids, _, _ in serving_prompts(cfg, SERVE_SLOTS)]


def scale_fold_gap(label, got, q, k, v, kw, scale) -> dict:
    """How far a forward kernel's bf16 output sits from the plain forward
    with the softmax scale applied to the f32 scores (the port's kernels)
    and from one that folds bf16(scale*log2(e)) into q rounded to bf16, as
    the JAX wrappers do (flash_mma.py:346, :653); beside each, the mean
    |error| of both plain versions and the kernel against f32 attention."""
    from aki_torch.ops.flash_mma import flash_mma_attention_reference as ref
    from aki_torch.ops.flash_mma_args import LOG2E

    qs = q * torch.tensor(scale * LOG2E, dtype=torch.bfloat16, device=q.device)
    f32_scale = ref(q, k, v, **kw, scale=scale).float()
    jax_fold = ref(qs, k, v, **kw, scale=math.log(2.0)).float()
    exact = ref(q.float(), k.float(), v.float(), **kw, scale=scale)
    got = got.float()
    rec = {"max_abs_vs_f32_scale_plain": (got - f32_scale).abs().max().item(),
           "max_abs_vs_jax_fold_plain": (got - jax_fold).abs().max().item(),
           "mean_abs_vs_f32_scale_plain": (got - f32_scale).abs().mean().item(),
           "mean_abs_vs_jax_fold_plain": (got - jax_fold).abs().mean().item(),
           "plain_f32_scale_vs_jax_fold_max": (f32_scale - jax_fold).abs().max().item(),
           "mean_err_vs_f32": {"kernel": (got - exact).abs().mean().item(),
                               "f32_scale_plain": (f32_scale - exact).abs().mean().item(),
                               "jax_fold_plain": (jax_fold - exact).abs().mean().item()}}
    log(f"scale fold {label}: {rec}")
    return rec


def flat_case(name, b, t, s, h, d, gen, causal=True, rects=None, lens=None, timed=False,
              zero_rows=None, scale_fold=False, kv_valid=None, q_offset=0,
              rounds=SPREAD_ROUNDS) -> dict:
    """K6 on the flat layout against its plain version (forward_gates on the
    (B,T,H,128) view), its pad lanes exactly 0 where V's are, and its real
    lanes against K1 on the unpadded tensors under the same element-wise
    gate. Returns the record, with the launches of its one counted call and
    the tile classes it ran; ``timed`` adds K6's times and, under "k1", K1
    held to its plain version and timed on the unpadded tensors, the device
    times each the median of ``rounds`` (device_rounds). Key validity from
    ``lens`` (a prefix per row) or ``kv_valid``."""
    from aki_torch.ops.flash_mma import (count_tiles, flash_mma_attention_flat,
                                         flash_mma_forward, forward_block_rows)

    q, k, v, spec = case_inputs(b, t, s, h, h, d, gen, rects)
    if lens is not None:
        kv_valid = prefix_valid(lens, s)
    qf, kf, vf = pad_heads(q, True), pad_heads(k, True), pad_heads(v, False)
    kw = dict(spec=spec, kv_valid=kv_valid, q_offset=q_offset, causal=causal)
    n0 = flash_mma_attention_flat.launches
    with count_tiles() as counts:
        got = flash_mma_attention_flat(qf, kf, vf, h, d, **kw)
    launched = flash_mma_attention_flat.launches - n0
    with count_tiles() as k1_counts:
        k1 = flash_mma_forward(q, k, v, spec, kv_valid, q_offset, causal)[0]
    torch.cuda.synchronize()
    view = lambda x: x.view(b, x.shape[1], h, FLAT_DP)  # noqa: E731
    rec = dict(name=name, shape=[b, t, s, h, FLAT_DP], head_dim=d, causal=causal,
               launches=launched,
               tiles=tile_gate(f"K6 {name}", counts[0], b, t, s, h, spec, kv_valid, q_offset,
                               causal, FLAT_DP),
               **forward_gates(f"K6 {name}", view(got), view(qf), view(kf), view(vf),
                               dict(kw, scale=d ** -0.5), zero_rows=zero_rows))
    real = view(got)[..., :d].float()
    rec["max_abs_vs_k1"] = (real - k1.float()).abs().max().item()
    pad_zero = bool((view(got)[..., d:] == 0).all())
    ok = (launched == 1 and pad_zero
          and bool(((real - k1.float()).abs() <= ATOL + RTOL * k1.float().abs()).all()))
    log(f"  K6 {name}: launches={launched} pad_lanes_zero={pad_zero} "
        f"max|real lanes - K1 unpadded|={rec['max_abs_vs_k1']:.6g} tiles={rec['tiles']} "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(f"chip_smoke: K6 {name} failed")
    if scale_fold:
        rec["scale_fold"] = scale_fold_gap(f"K6 {name}", view(got), view(qf), view(kf),
                                           view(vf), kw, d ** -0.5)
    if timed:
        from aki_torch.ops.flash_mma import flash_mma_attention_flat_reference

        allowed = case_allowed(b, t, s, spec, kv_valid, causal, q_offset)
        flops, nbytes = allowed_work(b, t, s, h, h, FLAT_DP, allowed, kv_valid is not None)
        t_flops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        qt, kt, vt = (view(x).transpose(1, 2) for x in (qf, kf, vf))
        mask = None if allowed is None else allowed[:, None]
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, scale=d ** -0.5)
        k6 = lambda: flash_mma_attention_flat(qf, kf, vf, h, d, **kw)  # noqa: E731
        rec.update(
            ms=cuda_ms(k6),
            **device_rounds(k6, sdpa, rounds),
            block_rows=forward_block_rows(b, t, h, FLAT_DP),
            plain_ms=cuda_ms(lambda: flash_mma_attention_flat_reference(qf, kf, vf, h, d, **kw)),
            library_ms=cuda_ms(sdpa),
            k1_unpadded_ms=cuda_ms(lambda: flash_mma_forward(q, k, v, spec, kv_valid, q_offset,
                                                             causal)),
            bound_ms=max(t_flops, t_bytes),
            bound_by="operations" if t_flops >= t_bytes else "bytes",
            bound_flops=flops, bound_bytes=nbytes)
        for key in ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
                    "k1_unpadded_ms", "bound_ms", "bound_by", "block_rows",
                    "device_ms_rounds", "library_device_ms_rounds", "burst_ms_rounds",
                    "library_burst_ms_rounds", "gemm_witness_tflops",
                    "profiler_launches_seen_of"):
            log(f"  K6 {name} {key}={rec.get(key)}")
        # K1 on the unpadded tensors, SDPA on the same unpadded tensors
        rec["k1"] = dict(name=f"{name}_k1", shape=[b, t, s, h, h, d], causal=causal,
                         tiles=tile_gate(f"{name}_k1", k1_counts[0], b, t, s, h, spec, kv_valid,
                                         q_offset, causal, 80 if d <= 80 else 96),
                         **forward_gates(f"kernel {name}_k1", k1, q, k, v, kw),
                         **time_forward(f"{name}_k1", q, k, v, kw, rounds))
    return rec


# K7 against its plain version on the same int8 operands and scales: the
# scores agree bit for bit (int32 exact, then the same f32 products); the
# two differ in f32 summation order and exp2's last bit, which can flip one
# bf16 rounding of a p * sv term. Gates: max |kernel - plain| <= Q8_REL *
# max|plain|; against f32 attention on the unquantized inputs the kernel's
# largest error within Q8_F32_RATIO of the plain version's; both within the
# JAX package's own gate for this kernel, Q8_JAX_GATE * max|ref|
# (tests/test_tpu_kernels.py:272).
Q8_REL, Q8_F32_RATIO, Q8_JAX_GATE = 2.0 ** -7, 1.1, 0.05
PEAK_INT8_OPS = 1979e12        # dense int8 tensor cores


def q8_work(b, t, s, h, d, allowed, has_valid):
    """(int8 ops, bf16 FLOPs, bytes) that K7's function needs: 2*D int8 ops
    (QK) and 2*D bf16 FLOPs (PV) per head and allowed pair; int8 q read and
    bf16 out written once, int8 k and v and the f32 scales of each key some
    row may attend (and its kv_valid) read once."""
    if allowed is None:
        pairs, keys = b * t * s, b * s
    else:
        pairs, keys = int(allowed.sum()), int(allowed.any(dim=1).sum())
    nbytes = b * t * h * (d + 4 + 2 * d) + keys * (h * (2 * d + 8) + 4 * has_valid)
    return 2 * d * h * pairs, 2 * d * h * pairs, nbytes


def q8_gates(label, got, q, k, v, kw, plain=None) -> dict:
    """Hold K7's bf16 output ``got`` to its plain version on the same
    quantized operands (``plain``, computed when not given) and both to f32
    attention on the unquantized inputs (Q8_REL, Q8_F32_RATIO, Q8_JAX_GATE);
    fails the script on a miss; returns the errors."""
    from aki_torch.ops.flash_mma import flash_mma_attention_reference
    from aki_torch.ops.flash_mma_q8 import flash_mma_attention_q8_reference

    if plain is None:
        plain = flash_mma_attention_q8_reference(q, k, v, **kw).float()
    exact = flash_mma_attention_reference(q.float(), k.float(), v.float(), **kw)
    diff = (got.float() - plain).abs()
    ref_max = exact.abs().max().item()
    err_k = (got.float() - exact).abs().max().item()
    err_p = (plain - exact).abs().max().item()
    rec = dict(max_abs_err=diff.max().item(), mean_abs_err=diff.mean().item(),
               max_abs_vs_f32=err_k, plain_max_abs_vs_f32=err_p, f32_max=ref_max)
    ok = (bool(torch.isfinite(got).all())
          and rec["max_abs_err"] <= Q8_REL * plain.abs().max().item()
          and err_k <= Q8_F32_RATIO * err_p + 1e-6
          and max(err_k, err_p) <= Q8_JAX_GATE * ref_max)
    log(f"{label}: q={tuple(q.shape)} k={tuple(k.shape)} causal={kw['causal']} "
        f"max|kernel - plain|={rec['max_abs_err']:.6g} (<= {Q8_REL:.6g} * max|plain|) "
        f"mean={rec['mean_abs_err']:.4g}; max error vs f32 attention on the unquantized "
        f"inputs: kernel {err_k:.6g} plain {err_p:.6g} (kernel <= {Q8_F32_RATIO}x plain; both "
        f"<= {Q8_JAX_GATE} * {ref_max:.4g}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(f"chip_smoke: {label} disagrees with its plain version")
    return rec


def q8_timings(q, k, v, kw, rounds: int) -> dict:
    """K7 at one shape: the kernel's device time alone (device_ms of
    flash_mma_q8_kernel over 20 calls of flash_mma_q8_forward on fixed
    operands) alternated over ``rounds`` rounds with K1's (flash_mma_fwd_kernel,
    flash_mma_forward on the same bf16 tensors), medians and each round;
    K7's device time with a 64 MB write before each call (cold_split_ms);
    the kernel's call and the whole wrapper's (quantize included) by CUDA
    events; the plain version's; the bound from q8_work."""
    from aki_torch.ops.flash_mma import flash_mma_forward
    from aki_torch.ops.flash_mma_q8 import (flash_mma_attention_q8, flash_mma_q8_forward,
                                            flash_mma_q8_plain, quantize_operands)

    b, t, h, d = q.shape
    s = k.shape[1]
    ops = quantize_operands(q, k, v, d ** -0.5)
    k7 = lambda: flash_mma_q8_forward(*ops, **kw)  # noqa: E731
    k1 = lambda: flash_mma_forward(q, k, v, kw["spec"], kw["kv_valid"],  # noqa: E731
                                   kw.get("q_offset", 0), kw["causal"])
    dev, k1_dev, seen = [], [], []
    for _ in range(rounds):
        dev.append(device_ms(k7, "flash_mma_q8_kernel"))
        seen.append(profiler_shortfall("flash_mma_q8_kernel"))
        k1_dev.append(device_ms(k1, "flash_mma_fwd_kernel"))
    cold = kernel_ms(cold_split_ms(k7), "flash_mma_q8_kernel")
    allowed = case_allowed(b, t, s, kw["spec"], kw["kv_valid"], kw["causal"],
                           kw.get("q_offset", 0))
    int_ops, flops, nbytes = q8_work(b, t, s, h, d, allowed, kw["kv_valid"] is not None)
    t_ops = (int_ops / PEAK_INT8_OPS + flops / PEAK_BF16_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return dict(
        ms=median_of(dev), device_ms_rounds=dev, profiler_launches_seen_of=seen,
        cold_ms=cold, call_ms=cuda_ms(k7),
        wrapper_ms=cuda_ms(lambda: flash_mma_attention_q8(q, k, v, **kw)),
        k1_device_ms=median_of(k1_dev), k1_device_ms_rounds=k1_dev,
        plain_ms=cuda_ms(lambda: flash_mma_q8_plain(*ops, **kw)), library_ms=None,
        bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
        bound_int8_ops=int_ops, bound_bf16_flops=flops, bound_bytes=nbytes)


def q8_case(name, b, t, s, h, hkv, d, gen, causal=True, rects=None, lens=None, timed=False,
            zero_rows=None, zero_q_row=None, routed=False, kv_valid=None, q_offset=0,
            rounds=SPREAD_ROUNDS) -> dict:
    """K7 through ``flash_mma_attention_q8`` against its plain version (the
    same routing and quantize), and both against f32 attention on the
    unquantized inputs (q8_gates); the tiles each of its two passes ran, as
    the kernel counted them (count_q8_tiles), held to the mirror's classes
    (tile_gate), and its launch plan to the mirror q8_plan. ``routed`` cases
    must launch the bf16 forward once and K7 never, and are held by
    forward_gates. Key validity from ``lens`` (a prefix per row) or
    ``kv_valid``. ``timed`` adds q8_timings and the bf16-P attention's call
    time. Returns the record."""
    from aki_torch.ops.attention import decoder_attention_bf16p, encoder_attention_bf16p
    from aki_torch.ops.flash_mma import flash_mma_attention
    from aki_torch.ops.flash_mma_q8 import (count_q8_tiles, flash_mma_attention_q8,
                                            kernel_plan, q8_plan)

    q, k, v, spec = case_inputs(b, t, s, h, hkv, d, gen, rects)
    if lens is not None:
        kv_valid = prefix_valid(lens, s)
    if zero_q_row is not None:
        q[zero_q_row] = 0
    kw = dict(spec=spec, kv_valid=kv_valid, q_offset=q_offset, causal=causal)
    n7, n1 = flash_mma_attention_q8.launches, flash_mma_attention.launches
    with count_q8_tiles() as counts:
        got = flash_mma_attention_q8(q, k, v, **kw)
    launched = {"q8": flash_mma_attention_q8.launches - n7,
                "flash_fwd": flash_mma_attention.launches - n1}
    torch.cuda.synchronize()
    rec = dict(name=name, shape=[b, t, s, h, hkv, d], causal=causal, launches=launched)
    want_launches = {"q8": 0, "flash_fwd": 1} if routed else {"q8": 1, "flash_fwd": 0}
    if routed:
        rec.update(forward_gates(f"K7 {name} (routed to the bf16 forward)", got, q, k, v, kw,
                                 zero_rows=zero_rows))
        ok = launched == want_launches and counts.sum().item() == 0
    else:
        rec.update(q8_gates(f"K7 {name}", got, q, k, v, kw))
        width = 80 if d <= 80 else 96
        rec["tiles"] = [tile_gate(f"K7 {name} pass {p + 1}", counts[p], b, t, s, h, spec,
                                  kv_valid, q_offset, causal, width) for p in range(2)]
        plan = kernel_plan(b, t, s, h)
        rec["plan"] = plan
        mirror = q8_plan(b, t, s, h, torch.cuda.get_device_properties(0).multi_processor_count)
        ok = launched == want_launches and plan == mirror
        if zero_rows is not None:
            ok = ok and bool((got[zero_rows[0], zero_rows[1]] == 0).all())
        log(f"  K7 {name}: launches={launched} plan={plan} (mirror {mirror}) "
            f"tiles per pass={rec['tiles']} {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(f"chip_smoke: K7 {name} failed (launches {launched}, "
                         f"want {want_launches})")
    if timed:
        bf16p = ((lambda: decoder_attention_bf16p(q, k, v, **{x: kw[x] for x in
                                                               ("spec", "kv_valid")}))
                 if causal else (lambda: encoder_attention_bf16p(q, k, v)))
        rec.update(q8_timings(q, k, v, kw, rounds), bf16p_ms=cuda_ms(bf16p))
        for key in ("ms", "device_ms_rounds", "cold_ms", "call_ms", "wrapper_ms",
                    "k1_device_ms", "k1_device_ms_rounds", "plain_ms", "bf16p_ms", "bound_ms",
                    "bound_by", "profiler_launches_seen_of"):
            log(f"  K7 {name} {key}={rec[key]}")
    return rec


def q8_tile_coverage(records) -> dict:
    """Which tile classes K7's cases ran in each pass, per padded width;
    fails the script unless both passes ran skip, full and partial at
    widths 80 and 96."""
    from aki_torch.ops.flash_mma_args import TILE_CLASS_NAMES

    cover: dict = {}
    for r in records:
        for p, tiles in enumerate(r.get("tiles", [])):
            by = cover.setdefault(f"{tiles['width']} pass {p + 1}",
                                  dict.fromkeys(TILE_CLASS_NAMES, 0))
            for n in TILE_CLASS_NAMES:
                by[n] += tiles[n]
    want = {f"{w} pass {p}" for w in (80, 96) for p in (1, 2)}
    ok = set(cover) == want and all(all(c.values()) for c in cover.values())
    log(f"K7 tile classes run, per width and pass: {cover} {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit("chip_smoke: K7's cases miss a tile class at some width")
    return cover


def flat_and_q8(cfg, prompt_a, prompt_b) -> tuple[list, list, dict]:
    """Phase 13: K6 and K7 through their wrappers at AKI-4B widths, each
    wrapper's launches read around its one counted call per case; returns
    the K6 and K7 records and the scale-fold record of K1 at request (a)'s
    prefill."""
    from aki_torch.ops.flash_mma import (flash_mma_attention, flash_mma_attention_flat,
                                         flash_mma_forward)
    from aki_torch.ops.flash_mma_q8 import flash_mma_attention_q8

    flash_mma_attention_flat.launches = flash_mma_attention_q8.launches = 0
    flash_mma_attention.launches = 0
    ph, sg = cfg.phi3, cfg.siglip
    n_vis = cfg.perceiver.num_latents
    gen = torch.Generator(device="cuda").manual_seed(13)
    b, t = SERVE_SLOTS, SERVE_BUCKET + n_vis - 1
    lens = serving_lengths(cfg)
    serve_rect = [(1, 1 + n_vis, 40 + n_vis)]     # <image> at 1, <|assistant|> at 40
    t_a, rect_a = request_spec(cfg, prompt_a["ids"], n_vis)
    t_b, rect_b = request_spec(cfg, prompt_b["ids"], n_vis)
    dec = (ph.num_heads, ph.head_dim)              # flat: H, real head dim
    dec8 = (ph.num_heads, ph.num_heads, ph.head_dim)   # q8: H, Hkv, D
    k6 = [flat_case("decoder_serving", b, t, t, *dec, gen, rects=serve_rect, lens=lens,
                    timed=True, scale_fold=True)]
    free_cuda()
    k6.append(flat_case("tower_serving", b, sg.num_patches, sg.num_patches, sg.num_heads,
                        sg.head_dim, gen, causal=False, timed=True))
    free_cuda()
    k6 += [flat_case("single_row", 2, 1, 300, *dec, gen, lens=[300, 151]),
           flat_case("s_1024", 1, t_a, 1024, *dec, gen, rects=[rect_a], lens=[t_a]),
           flat_case("t_37", 2, 37, 37, *dec, gen, rects=[(2, 10, 30)]),
           flat_case("dead_row", 2, 100, 100, *dec, gen, lens=[100, 0],
                     zero_rows=(1, slice(None))),
           flat_case("images16_qoffset_hole", 2, 201, 389, 4, ph.head_dim, gen,
                     rects=EDGE_RECTS_16, q_offset=torch.tensor([100, 188], device="cuda"),
                     kv_valid=holed_valid([301, 389], 389, [[20], [70, 200]])),
           flat_case("big_grid_edges", 12, 300, 389, ph.num_heads, ph.head_dim, gen,
                     rects=EDGE_RECTS_2, q_offset=89,
                     kv_valid=holed_valid([389] * 6 + [300] * 6, 389, [[64]] * 12)),
           flat_case("tower_hole_d72", 2, sg.num_patches, sg.num_patches, sg.num_heads,
                     sg.head_dim, gen, causal=False,
                     kv_valid=holed_valid([729, 700], 729, [[130], []]))]
    for bad, (s_len, width) in {"s_1025": (1025, FLAT_DP), "dp_96": (64, 96)}.items():
        x = torch.zeros(1, 16, ph.num_heads * width, dtype=torch.bfloat16, device="cuda")
        kv = torch.zeros(1, s_len, ph.num_heads * width, dtype=torch.bfloat16, device="cuda")
        try:
            flash_mma_attention_flat(x, kv, kv, ph.num_heads, ph.head_dim)
        except ValueError as e:
            log(f"  K6 {bad}: ValueError as required ({e})")
        else:
            raise SystemExit(f"chip_smoke: K6 {bad} did not raise ValueError")

    # K1 at request (a)'s prefill against the same two plain versions
    q, k, v, spec = case_inputs(1, t_a, prompt_a["max_len"], *dec8, gen, [rect_a])
    kv_valid = prefix_valid([t_a], prompt_a["max_len"])
    kw = dict(spec=spec, kv_valid=kv_valid, causal=True)
    k1_fold = scale_fold_gap("K1 prefill (a)", flash_mma_forward(q, k, v, **kw)[0], q, k, v,
                             kw, dec[1] ** -0.5)
    del q, k, v
    free_cuda()

    k7 = [q8_case("decoder_serving", b, t, t, *dec8, gen, rects=serve_rect, lens=lens,
                  timed=True)]
    free_cuda()
    k7.append(q8_case("tower_serving", b, sg.num_patches, sg.num_patches, sg.num_heads,
                      sg.num_heads, sg.head_dim, gen, causal=False, timed=True))
    free_cuda()
    k7 += [q8_case("request_a", 1, t_a, t_a, *dec8, gen, rects=[rect_a]),
           q8_case("gqa_hkv8", 1, t_a, t_a, ph.num_heads, 8, ph.head_dim, gen,
                   rects=[rect_a], routed=True),
           q8_case(f"t_{t_b}", 1, t_b, t_b, *dec8, gen, rects=[rect_b], routed=True),
           q8_case("zero_q_row_dead_rows", 2, 100, 100, 4, 4, ph.head_dim, gen,
                   lens=[100, 0], zero_rows=(1, slice(None)), zero_q_row=(0, 5, 1)),
           # edges of the tile classes at both widths: 16 images on and off
           # 64-key boundaries, q_offset with T < S and holes; three heads
           # at D = 72 (the operands padded to 16-byte rows, the last head's
           # box past the row)
           q8_case("images16_qoffset_hole_d72_h3", 2, 201, 389, 3, 3, 72, gen,
                   rects=EDGE_RECTS_16, q_offset=torch.tensor([100, 188], device="cuda"),
                   kv_valid=holed_valid([301, 389], 389, [[20], [70, 200]])),
           q8_case("images16_edges_d96", 1, 389, 389, 4, 4, 96, gen, rects=EDGE_RECTS_16,
                   lens=[389]),
           q8_case("t_37_d80", 2, 37, 37, 2, 2, 80, gen, rects=[(2, 10, 30)]),
           q8_case("dead_rows_d88", 2, 150, 150, 4, 4, 88, gen,
                   kv_valid=holed_valid([150, 0], 150, [[70], []]), zero_rows=(1, slice(None))),
           # 192-row blocks at both widths
           q8_case("big_grid_edges_d96", 12, 300, 389, 32, 32, 96, gen, rects=EDGE_RECTS_2,
                   q_offset=89, kv_valid=holed_valid([389] * 6 + [300] * 6, 389, [[64]] * 12)),
           q8_case("big_grid_tower_hole_d72", 24, sg.num_patches, sg.num_patches, sg.num_heads,
                   sg.num_heads, sg.head_dim, gen, causal=False,
                   kv_valid=holed_valid([729] * 23 + [500], 729, [[]] * 23 + [[130]])),
           # the longest single-tile sequence, and one past it (routed)
           q8_case("t_s_1024", 1, 1024, 1024, *dec8, gen, rects=[(5, 149, 300)], lens=[1000]),
           q8_case("t_s_1025", 1, 1025, 1025, *dec8, gen, rects=[(5, 149, 300)], routed=True)]
    for c in k7:
        if c["name"].startswith("big_grid") and c["plan"]["rows"] != 192:
            raise SystemExit(f"chip_smoke: K7 case {c['name']} ran 64-row blocks")
    free_cuda()
    return k6, k7, k1_fold


# Edge cases of the forward, chosen with flash_mma_args.tile_classes: 16
# images with edges at 64-key tile boundaries and one off them (tile
# boundaries are multiples of 64 for every block size), on sequences of
# lengths that no block size divides
EDGE_RECTS_16 = [(1, 63, 65), (62, 64, 127), (65, 129, 191), (126, 128, 193)] + [
    (130 + 21 * n, 141 + 21 * n, 151 + 21 * n) for n in range(12)]
EDGE_RECTS_2 = [(63, 129, 191), (193, 255, 321)]


def holed_valid(lens, s, holes) -> torch.Tensor:
    """prefix_valid(lens, s) with the keys ``holes`` (one list per row) set
    invalid: a hole inside a tile that is full but for it."""
    valid = prefix_valid(lens, s)
    for row, keys in enumerate(holes):
        valid[row, keys] = 0
    return valid


def tile_coverage(records) -> dict:
    """Which tile classes the forward's edge and main cases ran, per padded
    width, as the kernel counted them (tile_gate); fails the script unless
    every width ran skip, full and partial."""
    from aki_torch.ops.flash_mma_args import TILE_CLASS_NAMES

    cover: dict = {}
    for r in records:
        by = cover.setdefault(r["tiles"]["width"], dict.fromkeys(TILE_CLASS_NAMES, 0))
        for n in TILE_CLASS_NAMES:
            by[n] += r["tiles"][n]
    ok = set(cover) == {80, 96, FLAT_DP} and all(all(c.values()) for c in cover.values())
    log(f"forward tile classes run, per width: {cover} {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit("chip_smoke: the forward's cases miss a tile class at some width")
    return cover


def free_cuda() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    t_start = time.perf_counter()
    # 1. device
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from aki_torch.infer.engine import decode_step, generate, prefill
    from aki_torch.models.aki import AKIModel
    from aki_torch.models.common import F32
    from aki_torch.models.configs import aki_4b
    from aki_torch.ops import cuda_build
    from aki_torch.ops.flash_mma import flash_mma_attention

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    build_s = cuda_build.build_all(KERNEL_SOURCES)
    log(f"build seconds={time.perf_counter() - t0:.1f} nvcc_seconds={build_s}")
    for name in KERNEL_SOURCES:
        print_ptxas(name, (cuda_build.BUILD_DIR / f"{name}.log").read_text())

    cfg = aki_4b()
    requests = request_prompts(cfg)

    # 3. kernel against plain version, at the main path's shapes
    gen = torch.Generator(device="cuda").manual_seed(1)
    sg = cfg.siglip
    ph = cfg.phi3
    cases = [kernel_case("siglip", 1, sg.num_patches, sg.num_patches, sg.num_heads,
                         sg.num_heads, sg.head_dim, gen, causal=False, timed=True)]
    for r in requests:
        cases.append(kernel_case(
            f"decoder_prefill_{r['name']}", 1, r["t_full"], r["max_len"], ph.num_heads,
            ph.num_kv_heads, ph.head_dim, gen, rects=[r["rect"]],
            kv_valid=prefix_valid([r["t_full"]], r["max_len"]), timed=True))
    left_pad = prefix_valid([70, 70], 70)
    left_pad[0, :4] = 0           # rows 0..3 of batch row 0 have no allowed key
    cases += [
        kernel_case("two_image_union", 1, 300, 320, 4, 4, 96, gen,
                    rects=[(5, 70, 150), (160, 230, 290)],
                    kv_valid=prefix_valid([300], 320)),
        kernel_case("gqa_h8_hkv2", 2, 150, 150, 8, 2, 96, gen, rects=[(10, 50, 90)]),
        kernel_case("fully_masked_rows", 2, 70, 70, 4, 4, 72, gen,
                    kv_valid=left_pad, zero_rows=(0, slice(0, 4))),
        kernel_case("q_offset", 2, 40, 200, 4, 4, 96, gen,
                    q_offset=torch.tensor([100, 150], device="cuda"),
                    kv_valid=prefix_valid([140, 190], 200)),
        kernel_case("siglip_ragged_valid", 2, 729, 768, 16, 16, 72, gen,
                    causal=False, kv_valid=prefix_valid([729, 700], 768)),
        # edges of the tile classes (EDGE_RECTS_*, holed_valid)
        kernel_case("edges_pm1_d96", 1, 389, 389, 4, 4, 96, gen, rects=EDGE_RECTS_2,
                    kv_valid=prefix_valid([389], 389)),
        kernel_case("images16_qoffset_hole_d88", 2, 201, 389, 4, 4, 88, gen,
                    rects=EDGE_RECTS_16, q_offset=torch.tensor([100, 188], device="cuda"),
                    kv_valid=holed_valid([301, 389], 389, [[20], [70, 200]])),
        kernel_case("gqa_h32_hkv8_lse", 2, 300, 300, 32, 8, 96, gen, rects=EDGE_RECTS_2,
                    kv_valid=holed_valid([300, 257], 300, [[5], []]), lse=True),
        kernel_case("hole_dead_rows_d72", 2, 150, 150, 4, 4, 72, gen,
                    kv_valid=holed_valid([150, 0], 150, [[70], []]),
                    zero_rows=(1, slice(None)), lse=True),
        # 192-row blocks (three consumer warpgroups): grids of two waves
        kernel_case("big_grid_edges_d96", 12, 300, 389, 32, 32, 96, gen, rects=EDGE_RECTS_2,
                    q_offset=89, kv_valid=holed_valid([389] * 6 + [300] * 6, 389,
                                                      [[64]] * 12)),
        kernel_case("big_grid_tower_hole_d72", 24, 729, 729, 16, 16, 72, gen, causal=False,
                    kv_valid=holed_valid([729] * 23 + [500], 729, [[]] * 23 + [[130]])),
        # base-2 scores spread past 126 along each row: p and alpha that
        # exp2 flushes to 0 where the plain version keeps subnormals
        kernel_case("exp2_flush_spread_d96", 2, 389, 389, 4, 4, 96, gen, rects=EDGE_RECTS_2,
                    spread=True),
    ]

    # 4. full-width generation
    t0 = time.perf_counter()
    model = AKIModel(cfg, device="cuda", dtype=torch.bfloat16,
                     generator=torch.Generator(device="cuda").manual_seed(0))
    model.requires_grad_(False)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model aki_4b bf16 params={n_params} init_seconds={time.perf_counter() - t0:.1f}")
    img_gen = torch.Generator(device="cuda").manual_seed(2)
    launches = 0
    for r in requests:
        image = torch.rand(1, sg.image_size, sg.image_size, 3, device="cuda",
                           generator=img_gen) * 2 - 1
        valid = torch.ones_like(r["ids"])
        r["image"], r["valid"] = image, valid
        generate(model, r["ids"], image, valid, 2, r["max_len"])   # warm-up
        torch.cuda.synchronize()

        # prefill and decode times from the one counted call: events on the
        # stream at its start, after its prefill and at its end (the stream
        # is idle at the start, so the first event fires at once)
        start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        flash_mma_attention.launches = 0
        t0 = time.perf_counter()
        start.record()
        tokens, num = generate(model, r["ids"], image, valid, NEW_TOKENS, r["max_len"],
                               on_prefill=mid.record)
        end.record()
        end.synchronize()
        gen_ms = (time.perf_counter() - t0) * 1e3
        prefill_ms, decode_ms = start.elapsed_time(mid), mid.elapsed_time(end)
        n = flash_mma_attention.launches
        launches += n
        want = sg.num_layers + ph.num_layers
        toks = tokens[0].tolist()
        log(f"generate {r['name']}: text_tokens={r['n_txt']} spliced={r['t_full']} "
            f"max_len={r['max_len']} prefill_ms={prefill_ms:.2f} "
            f"decode_ms_per_token={decode_ms / NEW_TOKENS:.3f} "
            f"generate_ms={gen_ms:.1f} launches={n} tokens={toks}")
        if n != want:
            raise SystemExit(f"chip_smoke: {n} kernel launches in one generate, want {want}")
        if tokens.shape != (1, NEW_TOKENS) or int(num[0]) != NEW_TOKENS or not all(
                0 <= x < cfg.output_vocab for x in toks):
            raise SystemExit("chip_smoke: generated tokens out of shape or range")

    # where the time goes: one prefill of each request and one decode step
    for r in requests:
        args = (r["ids"], r["image"], r["valid"], r["max_len"])
        profile_call(f"prefill_{r['name']}", lambda: prefill(model, *args))
        state = prefill(model, *args)
        profile_call(f"decode_step_{r['name']}",
                     lambda: decode_step(model, state, state.last_logits.argmax(-1)))

    # 5. prefill logits in place: kernel against the plain attention, and
    # both against the same weights run in f32 (plain attention)
    r = requests[0]
    args = (r["ids"], r["image"], r["valid"], r["max_len"])
    with_kernel = prefill(model, *args).last_logits
    plain = prefill(model, *args, use_flash=False).last_logits
    model.float()
    f32 = prefill(model, *args, policy=F32, use_flash=False).last_logits
    if not all(torch.isfinite(x).all() for x in (with_kernel, plain, f32)):
        raise SystemExit("chip_smoke: non-finite prefill logits")
    cosine = lambda a, b: torch.nn.functional.cosine_similarity(a, b, dim=-1).item()  # noqa: E731
    cos, cos_k32, cos_p32 = cosine(with_kernel, plain), cosine(with_kernel, f32), cosine(plain, f32)
    same = bool((with_kernel.argmax(-1) == plain.argmax(-1)).all())
    log(f"prefill logits kernel vs plain: cosine={cos:.6f} (min {COSINE_MIN}) "
        f"argmax_equal={same} max_abs_diff={(with_kernel - plain).abs().max().item():.4g}; "
        f"cosine to the f32 model: kernel {cos_k32:.6f} plain {cos_p32:.6f}")
    if cos < COSINE_MIN or not same or 1 - cos_k32 > 2 * (1 - cos_p32) + 1e-4:
        raise SystemExit("chip_smoke: prefill logits with the kernel differ from plain")

    # 6.-8. training: free the inference model first; phase 11 serves the
    # same two requests
    del model, with_kernel, plain, f32, state
    int8_prompts = [{k: r[k] for k in ("name", "ids", "image", "valid", "max_len", "t_full")}
                    for r in requests]
    for r in requests:
        r.clear()
    free_cuda()
    from aki_torch.ops.masks import MMASpec

    batch_gen = torch.Generator().manual_seed(6)
    batches = [train_rows(cfg, batch_gen) for _ in range(2)]
    t_full, tspec, tvalid = train_spec(cfg, batches[0])
    tspec = MMASpec(*(x.cuda() for x in (tspec.img_start, tspec.txt_start, tspec.txt_end)))
    log(f"training batch: text={TRAIN_TEXT} spliced={t_full} "
        f"spec={[x.tolist() for x in (tspec.img_start, tspec.txt_start, tspec.txt_end)]} "
        f"valid_keys={tvalid.sum(1).tolist()}")
    gen = torch.Generator(device="cuda").manual_seed(5)
    # the frozen tower's forward at the training batch (no gradient, no lse);
    # the decoder's forward with lse is held inside each backward case
    cases.append(kernel_case("siglip_train", 2, sg.num_patches, sg.num_patches, sg.num_heads,
                             sg.num_heads, sg.head_dim, gen, causal=False))
    bwd = [backward_case("training", 2, t_full, t_full, ph.num_heads, ph.num_kv_heads,
                         ph.head_dim, gen, spec=tspec, kv_valid=tvalid.cuda(), timed=True),
           backward_case("siglip", 1, sg.num_patches, sg.num_patches, sg.num_heads,
                         sg.num_heads, sg.head_dim, gen, causal=False),
           backward_case("two_image_union", 1, 300, 320, 4, 4, 96, gen,
                         rects=[(5, 70, 150), (160, 230, 290)],
                         kv_valid=prefix_valid([300], 320)),
           backward_case("gqa_h8_hkv2", 2, 150, 150, 8, 2, 96, gen, rects=[(10, 50, 90)]),
           backward_case("fully_masked_rows", 2, 70, 70, 4, 4, 72, gen,
                         kv_valid=left_pad, zero_rows=(0, slice(0, 4))),
           backward_case("q_offset", 2, 40, 200, 4, 4, 96, gen,
                         q_offset=torch.tensor([100, 150], device="cuda"),
                         kv_valid=prefix_valid([140, 190], 200)),
           backward_case("siglip_ragged_valid", 2, 729, 768, 16, 16, 72, gen,
                         causal=False, kv_valid=prefix_valid([729, 700], 768)),
           # edges of the backward's tile classes and walks
           backward_case("images16_edges_d96", 1, 389, 389, 4, 4, 96, gen, rects=EDGE_RECTS_16,
                         kv_valid=prefix_valid([389], 389)),
           backward_case("qoffset_hole_d88", 2, 201, 389, 4, 4, 88, gen, rects=EDGE_RECTS_2,
                         q_offset=torch.tensor([100, 188], device="cuda"),
                         kv_valid=holed_valid([301, 389], 389, [[20], [70, 200]])),
           backward_case("gqa_h32_hkv8_train_len", 2, t_full, t_full, 32, 8, ph.head_dim, gen,
                         spec=tspec, kv_valid=tvalid.cuda()),
           backward_case("hole_dead_rows_d72", 2, 150, 150, 4, 4, 72, gen,
                         kv_valid=holed_valid([150, 0], 150, [[70], []]),
                         zero_rows=(1, slice(None))),
           # two-warpgroup blocks (128 rows or keys) at both widths
           backward_case("big_grid_edges_d96", 12, 300, 389, 32, 32, 96, gen, rects=EDGE_RECTS_2,
                         q_offset=89, kv_valid=holed_valid([389] * 6 + [300] * 6, 389,
                                                           [[64]] * 12)),
           backward_case("big_grid_tower_hole_d72", 8, 729, 729, 16, 16, 72, gen, causal=False,
                         kv_valid=holed_valid([729] * 7 + [500], 729, [[]] * 7 + [[130]])),
           # base-2 score spreads past 126: p that exp2 flushes to 0
           backward_case("exp2_flush_spread_d96", 2, 389, 389, 4, 4, 96, gen, rects=EDGE_RECTS_2,
                         spread=True)]
    for c in bwd:
        if c["name"].startswith("big_grid") and min(c["block_rows"].values()) <= 64:
            raise SystemExit(f"chip_smoke: backward case {c['name']} ran 64-row blocks")
    bwd_coverage = backward_tile_coverage(bwd)
    free_cuda()
    grads = whole_model_grads(cfg, batches[0])
    free_cuda()
    train = train_full_width(cfg, batches, t_full)
    free_cuda()

    # 9. the fused quantize kernels; 10. the int8-KV decode kernel
    gen = torch.Generator(device="cuda").manual_seed(7)
    fq_cases = fused_quant_phase(cfg, gen)
    dec_cases = decode_phase(cfg, int8_prompts, gen)

    # 11. int8 generation at full width and depth; 12. the serving engine
    model_q, int8_gen = int8_generation(cfg, int8_prompts)
    free_cuda()
    attn_times = prefill_attention_times(cfg, gen)
    serve = serve_drain(cfg, model_q)
    del model_q
    free_cuda()

    # 13. K6 and K7 through their wrappers: no path of the package runs them
    k6, k7, k1_fold = flat_and_q8(cfg, *int8_prompts)
    # K1 at the two B = 48 shapes of phase 13, and the tile classes that the
    # forward's cases ran at each width
    k1_b48 = [c["k1"] for c in k6 if "k1" in c]
    coverage = tile_coverage(cases + k1_b48 + k6)
    k7_coverage = q8_tile_coverage(k7)

    main_cases = [c for c in cases if "ms" in c]
    head = next(c for c in main_cases if c["name"] == "decoder_prefill_a")
    tb = bwd[0]
    per_step = train["steps"][0]["launches"]
    train_launches = {k: sum(st["launches"][k] for st in train["steps"]) for k in per_step}
    bwd_note = ("ms and cold_ms: this kernel's device time per call, torch.profiler over "
                "10 calls (cold: a 64 MB write before each); plain_ms, library_ms (CUDA "
                "events around one call) and library_device_ms / library_cold_device_ms "
                "(every SDPA kernel of the call) are of the whole backward (the plain "
                "backward, SDPA's backward through autograd); bound_ms is this kernel's "
                "own work")
    record = {"kernels": [{
        "name": "flash_mma_fwd", "route": "cuda",
        "source": "aki_torch/csrc/flash_mma_fwd.cu",
        "replaces": "aki_tpu/ops/flash_mma.py:175 (_kernel_1kv) and "
                    "aki_tpu/ops/flash_mma.py:79 (_kernel); its lse output carries "
                    "aki_tpu/ops/flash_mma_bwd.py:68 (_lse_kernel)",
        "launches": launches + train_launches["fwd"],
        "launches_by_path": {"generate": launches, "train": train_launches["fwd"]},
        "max_abs_err": max([c["max_abs_err"] for c in cases + k1_b48]
                           + [c["fwd_max_abs_err"] for c in bwd]),
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                "device_ms", "library_device_ms")},
        "shape": "decoder_prefill_a " + "x".join(map(str, head["shape"])),
        "timing_note": "ms and library_ms: CUDA events around one wrapper / SDPA call; "
                       "device_ms and library_device_ms: torch.profiler, the kernel's "
                       "(every SDPA kernel's) device time per call over 20 calls",
        "train_fwd_lse": {k: tb[k] for k in ("fwd_lse_ms", "fwd_lse_device_ms",
                                             "fwd_lse_bound_ms", "fwd_lse_bound_by",
                                             "fwd_plain_ms", "fwd_library_ms",
                                             "fwd_library_device_ms")},
        "shapes": main_cases,
        "b48": k1_b48,
        "tile_coverage": coverage,
        "sms": torch.cuda.get_device_properties(0).multi_processor_count,
    }] + [{
        "name": f"flash_mma_{kn}", "route": "cuda",
        "source": "aki_torch/csrc/flash_mma_bwd.cu",
        "replaces": ("aki_tpu/ops/flash_mma_bwd.py:111 (_dq_kernel)" if kn == "dq"
                     else "aki_tpu/ops/flash_mma_bwd.py:157 (_dkv_kernel)"),
        "launches": train_launches[kn],
        "max_abs_err": max(c[g]["max_abs_err"] for c in bwd
                           for g in (("dq",) if kn == "dq" else ("dk", "dv"))),
        "ms": tb[f"{kn}_ms"], "plain_ms": tb["plain_ms"], "bound_ms": tb[f"{kn}_bound_ms"],
        "bound_by": tb[f"{kn}_bound_by"], "library_ms": tb["library_ms"],
        "cold_ms": tb[f"cold_{kn}_ms"],
        **{k: tb[k] for k in ("library_device_ms", "library_burst_ms",
                              "library_cold_device_ms")},
        "shape": "training " + "x".join(map(str, tb["shape"])),
        "backward_ms": tb["ms"], "backward_device_ms": tb["device_ms"],
        "backward_burst_ms": tb["burst_ms"], "backward_cold_device_ms": tb["cold_device_ms"],
        "backward_bound_ms": tb["bound_ms"],
        "tile_coverage": bwd_coverage[kn],
        "note": bwd_note,
    } for kn in ("dq", "dkv")],
        "backward_cases": bwd, "whole_model": grads,
        "train": {k: train[k] for k in ("steps", "peak_bytes", "tokens_per_step")}}
    int8_runs = [r["launches"] for r in int8_gen["requests"]] + [serve["launches"]]
    k4 = dec_cases[0]
    timing_keys = ("ms", "device_ms", "cold_device_ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms")
    record["kernels"] += [{
        "name": "decode_attention", "route": "cuda",
        "source": "aki_torch/csrc/decode_attention.cu", "replaces": K4_REPLACES,
        "launches": sum(c["decode"] for c in int8_runs),
        "launches_by_path": {"int8_generate": sum(r["launches"]["decode"]
                                                  for r in int8_gen["requests"]),
                             "serve": serve["launches"]["decode"]},
        "max_abs_err": max(c["max_abs_err"] for c in dec_cases),
        **{k: k4["full"][k] for k in timing_keys},
        "shape": "serving cache 32x48x704x3072, all rows at 704 keys", "full": k4["full"],
        "ragged": k4["ragged"],
        "one_row": [{k: c[k] for k in ("name", "cache", "lengths", "cluster", "at_length")}
                    for c in dec_cases if "at_length" in c],
        "timing_note": "ms, layers_ms: CUDA events around one call, median of 20 (layers: "
                       "each call the next layer); device_ms (the layers in turn), "
                       "warm_device_ms (layer 1 again and again) and cold_device_ms (a "
                       "64 MB write before each call): the kernel's device time per call, "
                       "torch.profiler over 10 calls",
        "library_note": "no single PyTorch call attends over an int8 cache with "
                        "per-(token, head) scales",
        "cases": dec_cases,
    }] + [{
        "name": f"fused_quant_{op}", "route": "cuda", "source": "aki_torch/csrc/fused_quant.cu",
        "replaces": FUSED_QUANT_REPLACES[op],
        "launches": sum(c[op] for c in int8_runs),
        "launches_by_path": {"int8_generate": sum(r["launches"][op]
                                                  for r in int8_gen["requests"]),
                             "serve": serve["launches"][op]},
        "max_abs_err": max(c["max_abs_err"] for c in fq_cases[op]),
        **{k: fq_cases[op][0][k] for k in timing_keys},
        "shape": f"{fq_cases[op][0]['rows']}x{fq_cases[op][0]['d']}",
        "one_request": [{k: c[k] for k in ("rows", "d", *timing_keys)}
                        for c in fq_cases[op][1:] if "device_ms" in c],
        "library_note": "no single PyTorch call computes the op and the per-row int8 quantize",
        "cases": fq_cases[op],
    } for op in FUSED_QUANT_REPLACES]
    k6_head, k7_head = k6[0], k7[0]
    n6 = sum(c["launches"] for c in k6)
    n7 = sum(c["launches"]["q8"] for c in k7)
    record["kernels"] += [{
        "name": "flash_mma_flat", "route": "cuda", "source": "aki_torch/csrc/flash_mma_fwd.cu",
        "replaces": K6_REPLACES, "launches": n6, "launches_by_path": {"phase13": n6},
        "max_abs_err": max(c["max_abs_err"] for c in k6),
        **{k: k6_head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                   "device_ms", "library_device_ms")},
        "shape": "decoder_serving " + "x".join(map(str, k6_head["shape"])),
        "library_note": "SDPA with the boolean mask on the (B, H, T, 128) view",
        "scale_fold": {"k6_decoder_serving": k6_head["scale_fold"], "k1_prefill_a": k1_fold},
        "cases": k6,
    }, {
        "name": "flash_mma_q8", "route": "cuda", "source": "aki_torch/csrc/flash_mma_q8.cu",
        "replaces": K7_REPLACES, "launches": n7, "launches_by_path": {"phase13": n7},
        "max_abs_err": max(c["max_abs_err"] for c in k7),
        **{k: k7_head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                   "cold_ms", "call_ms", "wrapper_ms", "k1_device_ms")},
        "shape": "decoder_serving " + "x".join(map(str, k7_head["shape"])),
        "timing_note": "ms: the kernel's device time per call, torch.profiler over 20 calls, "
                       "median of the rounds; cold_ms the same after a 64 MB write before "
                       "each call; call_ms (the kernel's entry) and wrapper_ms (quantize "
                       "included): CUDA events; k1_device_ms: K1 on the same bf16 tensors",
        "library_note": "no PyTorch call attends over int8 operands with per-row scales",
        "tile_coverage": k7_coverage,
        "cases": k7,
    }]
    record.update(int8_generate=int8_gen, prefill_attention=attn_times, serve=serve)
    short = [(reps, seen) for reps, seen in PROFILER_SESSIONS
             if any(n % reps for n in seen.values()) or not seen]
    record["profiler_sessions"] = {"sessions": len(PROFILER_SESSIONS), "short": len(short)}
    log(f"profiler sessions of kernel_split_ms: {len(PROFILER_SESSIONS)}, of which {len(short)} "
        f"saw fewer launches than issued (or none): {short[:8]}")
    log(json.dumps(record))
    log(f"elapsed_seconds={time.perf_counter() - t_start:.1f}")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the aki_torch port's main path on one NVIDIA GPU and hold its
CUDA kernel against the plain PyTorch version.

Usage, from the root of a checkout, on a machine with one H100:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi); no card -> exit 1;
  2. build: nvcc for sm_90a of the path's one kernel source;
  3. kernels: each kernel against its plain version in bf16 at the main
     path's shapes and on edge cases, with times beside the bound and the
     PyTorch library call;
  4. generation: aki_4b() at full width (27-layer SigLIP, 6-layer Perceiver,
     32-layer Phi-3.5-mini), random bf16 weights from a seeded generator,
     32 greedy tokens for two requests (one 384x384 image + a prompt of
     ~60 text tokens with max_len 1024, and ~900 with max_len 1280);
     every count is zeroed just before each request and read just after;
  5. prefill in place: last-position logits with the kernel against the
     plain attention on the same model and request.
Then one JSON line of kernels, the card line, and the result line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

# H100 SXM data-sheet peaks at its full 700 W power limit; the card's own
# limit is printed beside every number
PEAK_BF16_FLOPS = 989e12      # dense bf16 tensor cores
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


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


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


def profile_call(name: str, fn, reps: int = 3) -> None:
    """The device's idle share of ``fn``: each of ``reps`` calls gives its
    own host wall time and the device time of what it ran (torch.profiler
    tracing the device only, one stream: device events do not overlap);
    the call with the median idle share is printed with its five costliest
    kernels, beside every call's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        per_name: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        busy_ms = sum(per_name.values())
        runs.append((1 - busy_ms / wall_ms, wall_ms, busy_ms, per_name))
    if any(r[2] == 0 for r in runs):
        log(f"profile {name}: wall_ms={[round(r[1], 3) for r in runs]} device time "
            f"not measured (the profiler saw no device events)")
        return
    runs.sort(key=lambda r: r[0])
    idle, wall_ms, busy_ms, per_name = runs[len(runs) // 2]
    attn_ms = sum(v for k, v in per_name.items() if "flash_mma_fwd" in k)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"profile {name}: median of {reps} calls: wall_ms={wall_ms:.3f} "
        f"device_busy_ms={busy_ms:.3f} idle_share={idle:.3f} "
        f"(all calls {[round(r[0], 3) for r in runs]}) flash_mma_fwd_ms={attn_ms:.3f} top="
        + "; ".join(f"{k[:60]}={v:.3f}" for k, v in top))


def prompt_ids(cfg, n_txt: int, gen: torch.Generator) -> torch.Tensor:
    """One chat prompt of ``n_txt`` ids: <s> <|user|> <image> text...
    <|end|> <|assistant|>, the text drawn from ``gen``."""
    text = torch.randint(100, 32000, (n_txt - 5,), generator=gen)
    head = torch.tensor([1, 32010, cfg.media_token_id])
    tail = torch.tensor([32007, cfg.assistant_token_id])
    return torch.cat([head, text, tail])[None].to(torch.int32)


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


def kernel_case(name, b, t, s, h, hkv, d, gen, causal=True, rects=None,
                kv_valid=None, q_offset=0, timed=False, zero_rows=None):
    """One kernel-vs-plain comparison on the card; returns its record.
    ``zero_rows`` = (batch row, query rows) that must come out exactly 0."""
    from aki_torch.ops.flash_mma import (flash_mma_attention,
                                         flash_mma_attention_reference)
    from aki_torch.ops.masks import MMASpec, allowed_mask, causal_spec

    dev = "cuda"
    q = torch.randn(b, t, h, d, device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn(b, s, hkv, d, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(b, s, hkv, d, device=dev, generator=gen).to(torch.bfloat16)
    spec = None
    if rects is not None:
        spec = MMASpec(*(torch.tensor([[r[i] for r in rects]] * b, dtype=torch.int32,
                                      device=dev) for i in range(3)))
    kw = dict(spec=spec, kv_valid=kv_valid, q_offset=q_offset, causal=causal)

    got = flash_mma_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = flash_mma_attention_reference(q, k, v, **kw)
    diff = (got.float() - want.float()).abs()
    abs_err = diff.max().item()
    rel_err = abs_err / max(want.float().abs().max().item(), 1e-30)
    # both against the same attention in f32 on the same bf16 inputs: the
    # kernel should be as close to it as the plain version is
    exact = flash_mma_attention_reference(q.float(), k.float(), v.float(), **kw)
    kernel_vs_f32 = (got.float() - exact).abs().mean().item()
    plain_vs_f32 = (want.float() - exact).abs().mean().item()
    ok = (bool(torch.isfinite(got).all())
          and bool((diff <= ATOL + RTOL * want.float().abs()).all())
          and kernel_vs_f32 <= F32_ERR_RATIO * plain_vs_f32 + 1e-7)
    if zero_rows is not None:
        ok = ok and bool((got[zero_rows[0], zero_rows[1]] == 0).all())
    rec = dict(name=name, shape=[b, t, s, h, hkv, d], causal=causal,
               max_abs_err=abs_err, max_rel_err=rel_err,
               mean_abs_err_vs_f32=kernel_vs_f32, plain_mean_abs_err_vs_f32=plain_vs_f32)
    log(f"kernel {name}: q={tuple(q.shape)} k={tuple(k.shape)} causal={causal} "
        f"max_abs_err={abs_err:.6g} max_rel_err={rel_err:.6g} "
        f"tol=|d|<={ATOL}+{RTOL}*|plain|; mean |err| vs f32 attention: kernel "
        f"{kernel_vs_f32:.4g} plain {plain_vs_f32:.4g} (kernel <= {F32_ERR_RATIO}x plain) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(f"chip_smoke: kernel case {name} disagrees with the plain version")

    if timed:
        allowed = None
        if causal:
            allowed = allowed_mask(spec or causal_spec(b, dev), t, s, kv_valid, q_offset)
        elif kv_valid is not None:
            allowed = (kv_valid[:, None, :] != 0).expand(b, t, s)
        flops, nbytes = allowed_work(b, t, s, h, hkv, d, allowed, kv_valid is not None)
        t_flops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        # the library yardstick: one SDPA call with the same boolean mask
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if hkv != h:
            kt = kt.repeat_interleave(h // hkv, 1)
            vt = vt.repeat_interleave(h // hkv, 1)
        mask = None if allowed is None else allowed[:, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        rec.update(
            ms=cuda_ms(lambda: flash_mma_attention(q, k, v, **kw)),
            plain_ms=cuda_ms(lambda: flash_mma_attention_reference(q, k, v, **kw)),
            library_ms=cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask)),
            bound_ms=max(t_flops, t_bytes),
            bound_by="operations" if t_flops >= t_bytes else "bytes",
            bound_flops=flops, bound_bytes=nbytes,
        )
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
            log(f"  {name} {key}={rec[key]}")
    return rec


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

    # 2. build
    t0 = time.perf_counter()
    build_s = cuda_build.build("flash_mma_fwd")
    log(f"build seconds={time.perf_counter() - t0:.1f} nvcc_seconds={build_s:.1f}")
    for line in (cuda_build.BUILD_DIR / "flash_mma_fwd.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    cfg = aki_4b()
    n_vis = cfg.perceiver.num_latents
    host_gen = torch.Generator().manual_seed(0)
    requests = [dict(name="a", n_txt=60, max_len=1024),
                dict(name="b", n_txt=900, max_len=1280)]
    for r in requests:
        r["ids"] = prompt_ids(cfg, r["n_txt"], host_gen)
        r["t_full"], r["rect"] = request_spec(cfg, r["ids"], n_vis)

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

    main_cases = [c for c in cases if "ms" in c]
    head = next(c for c in main_cases if c["name"] == "decoder_prefill_a")
    record = {"kernels": [{
        "name": "flash_mma_fwd", "route": "cuda",
        "source": "aki_torch/csrc/flash_mma_fwd.cu",
        "replaces": "aki_tpu/ops/flash_mma.py:175 (_kernel_1kv) and "
                    "aki_tpu/ops/flash_mma.py:79 (_kernel)",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shape": "decoder_prefill_a " + "x".join(map(str, head["shape"])),
        "shapes": main_cases,
    }]}
    log(json.dumps(record))
    log(f"elapsed_seconds={time.perf_counter() - t_start:.1f}")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""A/B of the MMA-mask test inside the flash forward kernel, on one GPU.

``aki_torch/csrc/flash_mma_fwd.cu`` (K1, K2, K6) tests a score against the
image rectangles with a loop over the images per score; the int8 forward
``flash_mma_q8.cu`` (K7) tests it in O(1): a bitmask of the images whose
query span holds the row (per thread, once per block) against a bitmask of
the images whose text span holds the key (per tile). This script builds a
copy of ``flash_mma_fwd.cu`` with K7's test into ``build/aki_torch/`` and
times both forwards, and K7, at the serving admission shape (48 rows of
655 decoder tokens, 32 heads x 96) with and without the rectangle, and at
the tower (48 x 729, 16 x 72), checking that the two forwards agree bit for
bit. Median of 20 launches by CUDA events, the shipped forward timed before
and after the copy.

Usage, from the root of a checkout, on a machine with one H100:

    python3 exp_torch/mask_ab.py
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

# (before, after) in flash_mma_fwd.cu: K7's bitmask test of the rectangles
PATCH = [
    ("  const int row_abs[2] = {q_first + rw + g, q_first + rw + g + 8};\n",
     "  const int row_abs[2] = {q_first + rw + g, q_first + rw + g + 8};\n"
     "  __shared__ uint32_t key_img_s[kBlockN];\n"
     "  uint32_t row_img[2] = {0u, 0u};\n"
     "  for (int r = 0; r < 2; ++r)\n"
     "    for (int n = 0; n < n_img; ++n)\n"
     "      if (row_abs[r] >= i0_s[n] && row_abs[r] < t0_s[n]) row_img[r] |= 1u << n;\n"),
    ("      valid_s[tid] = key < S && (kv_valid == nullptr || kv_valid[(size_t)b * S + key] != 0);\n",
     "      valid_s[tid] = key < S && (kv_valid == nullptr || kv_valid[(size_t)b * S + key] != 0);\n"
     "      uint32_t bits = 0u;\n"
     "      for (int n = 0; n < n_img; ++n)\n"
     "        if (key >= t0_s[n] && key < t1_s[n]) bits |= 1u << n;\n"
     "      key_img_s[tid] = bits;\n"),
    ("        bool ok = valid_s[kc] != 0;\n"
     "        if (ok && causal && key > row_abs[r]) {\n"
     "          bool mma = false;\n"
     "          for (int n = 0; n < n_img; ++n)\n"
     "            mma |= row_abs[r] >= i0_s[n] && row_abs[r] < t0_s[n] &&\n"
     "                   key >= t0_s[n] && key < t1_s[n];\n"
     "          ok = mma;\n"
     "        }\n",
     "        const bool ok = valid_s[kc] != 0 &&\n"
     "            (!causal || key <= row_abs[r] || (row_img[r] & key_img_s[kc]) != 0);\n"),
]


def build_variant(cuda_build) -> ctypes.CDLL:
    src = (cuda_build.CSRC / "flash_mma_fwd.cu").read_text()
    for before, after in PATCH:
        if before not in src:
            raise SystemExit("mask_ab: flash_mma_fwd.cu no longer has the per-score loop")
        src = src.replace(before, after)
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = cuda_build.BUILD_DIR / "flash_mma_fwd_bitmask.cu"
    path.write_text(src)
    lib_path = cuda_build.BUILD_DIR / "libflash_mma_fwd_bitmask.so"
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib_path),
                           str(path)], capture_output=True, text=True)
    print("\n".join(line.strip() for line in (proc.stdout + proc.stderr).splitlines()
                    if "registers" in line or "error" in line))
    if proc.returncode:
        raise SystemExit("mask_ab: nvcc failed")
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_mma_fwd.argtypes = [p] * 10 + [i] * 8 + [ctypes.c_float, p]
    lib.flash_mma_fwd.restype = i
    lib.flash_mma_error_string.argtypes = [i]
    lib.flash_mma_error_string.restype = ctypes.c_char_p
    return lib


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("mask_ab: no CUDA device")
        return 1
    from aki_torch.ops import cuda_build, flash_mma as fm, flash_mma_q8 as fq8
    from aki_torch.ops.masks import MMASpec

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build_all(["flash_mma_fwd", "flash_mma_q8"])
    shipped, variant = fm._kernel_lib(), build_variant(cuda_build)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {  # name: (B, T, H, D, causal, rectangle, ragged kv_valid)
        "decoder_mma_ragged": (48, 655, 32, 96, True, True, True),
        "decoder_causal": (48, 655, 32, 96, True, False, False),
        "decoder_noncausal": (48, 655, 32, 96, False, False, False),
        "tower_noncausal": (48, 729, 16, 72, False, False, False),
        "request_a_mma": (1, 203, 32, 96, True, True, False),
    }
    for name, (b, t, h, d, causal, rect, ragged) in cases.items():
        q, k, v = (torch.randn(b, t, h, d, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        spec = (MMASpec(*(torch.full((b,), x, dtype=torch.int32, device="cuda")
                          for x in (1, 145, 184))) if rect else None)
        kv_valid = None
        if ragged:
            lens = torch.randint(400, t + 1, (b,), generator=gen, device="cuda")
            kv_valid = (torch.arange(t, device="cuda")[None] < lens[:, None]).to(torch.int32)
        fwd = lambda: fm.flash_mma_forward(q, k, v, spec, kv_valid, 0, causal)[0]  # noqa: E731
        ops = fq8.quantize_operands(q, k, v, d ** -0.5)
        res = {"loop_ms": cuda_ms(fwd)}
        want = fwd()
        fm._lib = variant
        res["bitmask_ms"] = cuda_ms(fwd)
        res["bit_equal"] = bool(torch.equal(fwd(), want))
        fm._lib = shipped
        res["loop_again_ms"] = cuda_ms(fwd)
        res["k7_ms"] = cuda_ms(lambda: fq8.flash_mma_q8_forward(*ops, spec, kv_valid, 0, causal))
        print(name, [b, t, h, d], f"causal={causal} rect={rect} ragged={ragged}", res, flush=True)
        if not res["bit_equal"]:
            raise SystemExit(f"mask_ab: the bitmask forward differs at {name}")
        del q, k, v, ops
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where a block of the int8-operand flash forward (aki_torch/csrc/
flash_mma_q8.cu, K7) spends its cycles, at the two 48-row shapes of
chip_smoke.py's phase 13 (serving admission 48 x 655, 32 heads x 96, MMA,
ragged; tower 48 x 729, 16 x 72, non-causal).

Usage, from the root of a checkout, on a machine with one H100:

    python3 exp_torch/q8_phases.py [--out FILE]

It writes a copy of the kernel source into the git-ignored build/q8_phases/
with clock64() stamps added at fixed points of the first consumer thread
of every block of head 0 (the text it inserts after must occur once in the
source, or the script stops), builds it with the checkout's nvcc flags,
runs it three times on fixed inputs and reads the stamps back. Per block,
in SM cycles from the block's start: the consumers' shared prologue done
(scales in shared memory, Q ready), pass 1 done, pass 2 done; the cycles
pass 1 waited for K and pass 2 for V; the tiles the warpgroup computed.
Prints the medians and the cycles per computed tile of each pass, beside
the kernel's device time (chip_smoke.device_ms) and the SM clock; writes
the records as one JSON object to FILE (default
chiprun_out/q8_phases.json).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "exp_torch"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import q8_ab  # noqa: E402

# (text of the kernel source, what to insert after it; an mbar_wait line is
# replaced by a timed copy): the stamps of SLOTS
STAMPS = [
    ("  __syncthreads();\n",
     "  const long long t_start = clock64();\n"
     "  const bool stamp = h == 0 && tid == 0;\n"
     "  long long* st_row = g_stamps[b * gridDim.x + blockIdx.x];\n"),
    ("  asm volatile(\"bar.sync 1, %0;\\n\" ::\"n\"(kConsumers) : \"memory\");\n",
     "  if (stamp) st_row[0] = clock64() - t_start;\n"
     "  long long k_wait = 0;\n"),
    ("    mbar_wait(&kbar[j], 0);\n",
     "    if (stamp) k_wait -= clock64();\n"
     "    mbar_wait(&kbar[j], 0);\n"
     "    if (stamp) k_wait += clock64();\n"),
    ("    for (int i = 0; i < 32; ++i) m_row[(i >> 1) & 1] = fmaxf(m_row[(i >> 1) & 1], s[i]);\n"
     "  }\n",
     "  if (stamp) {\n"
     "    st_row[1] = clock64() - t_start;\n"
     "    st_row[4] = __popc(todo);\n"
     "    st_row[5] = k_wait;\n"
     "  }\n"
     "  long long v_wait = 0;\n"),
    ("    mbar_wait(&full[st], (r / stages) & 1);\n",
     "    if (stamp) v_wait -= clock64();\n"
     "    mbar_wait(&full[st], (r / stages) & 1);\n"
     "    if (stamp) v_wait += clock64();\n"),
    ("  if (!has_rows) return;\n",
     "  if (stamp) { st_row[2] = clock64() - t_start; st_row[3] = v_wait; }\n"),
]
SLOTS = ("prologue_done", "pass1_done", "pass2_done", "pass2_v_wait", "tiles",
         "pass1_k_wait")


def stamped_source(dst_dir: str) -> str:
    src = open(os.path.join(ROOT, "aki_torch", "csrc", "flash_mma_q8.cu")).read()
    for anchor, add in STAMPS:
        if src.count(anchor) != 1:
            raise SystemExit(f"q8_phases: the source does not hold this text once:\n{anchor}")
        if anchor.lstrip().startswith("mbar_wait"):
            src = src.replace(anchor, add)
        else:
            src = src.replace(anchor, anchor + add)
    src = src.replace("namespace {\n", "__device__ long long g_stamps[4096][8];\nnamespace {\n", 1)
    src += ('\nextern "C" int q8_stamps(void* dst) {\n'
            '  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps));\n}\n')
    os.makedirs(dst_dir, exist_ok=True)
    shutil.copy(os.path.join(ROOT, "aki_torch", "csrc", "hopper.cuh"), dst_dir)
    path = os.path.join(dst_dir, "flash_mma_q8_stamped.cu")
    with open(path, "w") as f:
        f.write(src)
    return path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "q8_phases.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("q8_phases: no CUDA device", flush=True)
        return 1
    from aki_torch.models.configs import aki_4b
    from aki_torch.ops.flash_mma_args import kernel_mask_args
    from aki_torch.ops.flash_mma_q8 import quantize_operands

    card = cs.card_line()
    cs.log(card)
    out_dir = os.path.join(ROOT, "build", "q8_phases")
    path = stamped_source(out_dir)
    libs = q8_ab.build([path], out_dir)
    (_, lib, strided), = q8_ab.variants([path], libs)
    cfg = aki_4b()
    ph, sg = cfg.phi3, cfg.siglip
    n_vis = cfg.perceiver.num_latents
    b, t_adm = cs.SERVE_SLOTS, cs.SERVE_BUCKET + n_vis - 1
    gen = torch.Generator(device="cuda").manual_seed(13)
    shapes = {
        "admission": ((b, t_adm, t_adm, ph.num_heads, ph.num_heads, ph.head_dim),
                      [(1, 1 + n_vis, 40 + n_vis)], cs.serving_lengths(cfg), True),
        "tower": ((b, sg.num_patches, sg.num_patches, sg.num_heads, sg.num_heads, sg.head_dim),
                  None, None, False),
    }
    record = {"card": card, "cases": {}}
    for shape, (dims, rects, lens, causal) in shapes.items():
        q, k, v, spec = cs.case_inputs(*dims, gen, rects)
        kv_valid = None if lens is None else cs.prefix_valid(lens, dims[2])
        ops = quantize_operands(q, k, v, dims[-1] ** -0.5)
        mask = kernel_mask_args(spec, kv_valid, 0, dims[0], dims[2], q.device)
        out = torch.empty(q.shape, dtype=torch.bfloat16, device="cuda")
        call = q8_ab.launcher(lib, strided, ops, out, mask, causal)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        stamps = np.zeros((4096, 8), np.int64)
        if lib.q8_stamps(stamps.ctypes.data) != 0:
            raise SystemExit("q8_phases: cannot read the stamps")
        blocks = stamps[:dims[0] * -(-dims[1] // 192), :len(SLOTS)]
        tiles = np.maximum(blocks[:, 4], 1)
        rec = {name: float(np.median(blocks[:, i])) for i, name in enumerate(SLOTS)}
        rec["pass1_per_tile"] = float(np.median((blocks[:, 1] - blocks[:, 0]) / tiles))
        rec["pass2_per_tile"] = float(np.median((blocks[:, 2] - blocks[:, 1]) / tiles))
        rec["blocks"] = int(len(blocks))
        rec["device_ms"] = cs.device_ms(call, "flash_mma_q8_kernel")
        rec["clock"] = cs.sm_clock()
        cs.log(f"{shape}: median SM cycles per block of head 0 {rec}")
        record["cases"][shape] = rec
        del q, k, v, ops, out, call
        cs.free_cuda()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f)
    cs.log(card)
    print(json.dumps({"ok": True, "out": args.out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

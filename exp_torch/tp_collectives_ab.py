#!/usr/bin/env python3
"""Training over the ``tensor`` axis with two ways of summing the ranks'
partial products, each against one card on the same rows and weights.

Usage, from the root of a checkout, on a machine with four H100s:

    torchrun --standalone --nproc-per-node 4 exp_torch/tp_collectives_ab.py \\
        [--out FILE] [--device cuda|cpu]

The variants, in A B A order:

- ``f32``: the checkout's ``aki_torch.parallel.tensor`` (each rank's
  partial product in f32, summed in f32, rounded once);
- ``bf16``: each partial product rounded to the compute dtype, then summed
  in it (the plain Megatron form: a bf16 product, a bf16 all-reduce).

Each runs ``aki_torch.parallel.dryrun.tp_train_modes`` (``tp_train``: the
model at AKI-4B width, 2 rows of 656 spliced tokens, 3 AdamW steps at
``tensor`` = world and, on four ranks, fsdp=2 x tensor=2), whose rank 0
also runs one card with its kernels and with the plain attention. Its
gates are printed, not enforced. Prints the loss and grad_norm of each
step relative to one card's, per variant and mesh; rank 0 writes them as
one JSON object to FILE (default build/tp_collectives_ab.json).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from aki_torch.models.configs import aki_4b, aki_tiny  # noqa: E402
from aki_torch.parallel import dryrun, tensor  # noqa: E402


def bf16_partials():
    """Patch the partial products and their sum to the compute dtype."""

    def matmul(x, wt):
        return tensor._matmul(x, wt)

    def sum_(y, group, dtype):
        dist.all_reduce(y, group=group)
        return y.to(dtype)

    return {"_matmul_f32": matmul, "_sum_f32": sum_}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "tp_collectives_ab.json"))
    cli = ap.parse_args()
    device = dryrun.init_distributed(cli.device, timeout_s=300.0)
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    args = argparse.Namespace(precision="bf16", loss_rtol=dryrun.LOSS_RTOL, modes=["tp_train"],
                              train_text=512 if cuda else 16)
    args.tp_train_text = args.train_text + 1
    ctx = dict(cfg=aki_4b() if cuda else aki_tiny(), device=device,
               world=dist.get_world_size(), rank=dist.get_rank(),
               dir=os.path.join(ROOT, "build", "tp_collectives_ab"))
    committed = {k: getattr(tensor, k) for k in ("_matmul_f32", "_sum_f32")}
    out = {}
    for name in ("f32", "bf16", "f32 again"):
        for k, fn in (bf16_partials() if name == "bf16" else committed).items():
            setattr(tensor, k, fn)
        r = dryrun.tp_train_modes(args, ctx)
        out[name] = {"one_card_plain_vs_kernels": r["one_card_plain_vs_kernels"], **{
            k: {"loss_rel": v["loss_rel"], "grad_norm_rel": v["grad_norm_rel"]}
            for k, v in r.items() if isinstance(v, dict) and "loss_rel" in v}}
        dryrun.log(f"tp_collectives_ab {name}: {out[name]}")
    for k, fn in committed.items():
        setattr(tensor, k, fn)
    if ctx["rank"] == 0:
        os.makedirs(os.path.dirname(os.path.abspath(cli.out)), exist_ok=True)
        with open(cli.out, "w") as f:
            f.write(json.dumps(dict(card=torch.cuda.get_device_name(device) if cuda else "cpu",
                                    gates_failed=dryrun.FAILED, **out)) + "\n")
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

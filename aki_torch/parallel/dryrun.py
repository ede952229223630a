"""The multi-device modes, one step set each, on every rank of a group
(counterpart of ``__graft_entry__.py:dryrun_multichip``)::

    torchrun --standalone --nproc-per-node 4 -m aki_torch.parallel.dryrun \\
        [--device cuda|cpu] [--modes zero3,zero2,ckpt,tp,sp,pp,ep,tp_train,tp_seq,
        tp_f32,tp_w8a8,tp_moe,offload] [--out FILE]

On the cards (NCCL) the model is AKI-4B at full width in bf16; with
``--device cpu`` (gloo) it is ``aki_tiny`` with 4 decoder layers in fp32. Each mode is held to a
run of rank 0 alone on the same rows (``Trainer(distributed=False)``,
``engine.generate`` unsharded); a failed gate is printed when it fails, the
other modes still run, and the run exits 1 at its end:

- ``zero3`` / ``zero2``: ``fsdp`` = world, ``fsdp_strategy`` ``full`` /
  ``grad_op``; every rank's micro-batch is the same two rows, so the global
  batch is their copies and its loss is the two rows' (grad_accum 2, 3
  steps); loss and grad_norm against rank 0 alone within ``LOSS_RTOL``;
  peak memory per card and step ms;
- ``ckpt``: the ZeRO-3 state saved (gathered, rank 0 writes), restored on
  rank 0 alone, every weight and AdamW moment bitwise; with ``tp_train`` on
  four ranks the fsdp=2 x tensor=2 state instead (its tensor blocks
  gathered part by part), and both when ``zero3`` is asked for too;
- ``tp``: ``tensor`` = world; one request's prefill logits against rank 0
  alone (cosine >= 0.995, same argmax), 16 greedy tokens, a ``kv_int8``
  drain of 16 requests, K1 / K4 launches counted; token agreement printed;
- ``sp``: ``seq`` = world, two rows of ``sp_tokens`` spliced tokens (4,096
  on the cards), remat ``full``, by the ring and by the all-gather route; one
  step's loss and grad_norm against rank 0 alone within ``LOSS_RTOL``; the
  K/V rows and bytes each rank held.

- ``pp``: ``pipe`` = world with as many microbatches, four rows (two
  copies of the zero modes' two rows), 3 steps against the zero modes'
  reference within ``LOSS_RTOL``;
- ``ep``: ``expert`` = world, and (on four ranks) ``data=2 x expert=2``,
  where the tokens are split too; one MoE layer at the model's width
  against the unsharded layer (outputs, aux, drops against a count on the
  host), then the MoE model cut to ``--ep-layers`` layers, 3 steps a mesh,
  the second mesh's first step against the first's;
- ``tp_train``: ``tensor`` = world, and (on four ranks) fsdp=2 x tensor=2,
  two rows of 656 spliced tokens (``tp_text`` + the image), 3 steps each
  against rank 0 alone on the same rows; K1 / dq / dkv launches a step,
  peak memory a card, step ms. Rank 0 alone runs twice, with the kernels
  and with the plain attention: their parting is how far two bf16
  implementations of one card part after AdamW's first updates. A route
  that attends with the kernels is held to the kernels' run, the ring
  (plain block attention) to the plain run; step 1 within ``LOSS_RTOL``,
  steps 2-3 within twice the one-card parting at that step and metric, or
  ``LOSS_RTOL`` where that is larger (phase 7's form); the fixed-bound
  reading of every step against the kernels' run is printed beside it;
- ``tp_seq``: tensor=2 x seq=2 (four ranks) by the ring and by the
  all-gather, on the same rows and gates;
- ``tp_f32``: what the bf16 meshes' parting from one card is made of: the
  ``tensor`` = world and (four ranks) tensor=2 x seq=2 ring meshes in fp32,
  with the plain attention on every side (the kernels take bf16 only), at
  the model's width and ``F32_LAYERS`` decoder layers, on ``tp_train``'s rows
  and on a second draw (``F32_ROW_SEEDS``), 3 steps each against rank 0
  alone within ``F32_RTOL``;
- ``tp_w8a8``: W8A8 weights and the int8 KV cache at ``tensor`` = world:
  the projections whole, attention (K1 in prefill, K4 in decode) on the
  rank's heads; one request's int8 prefill logits against rank 0's bf16 and
  f32 runs of the same weights under ``DRIFT_MEAN_MAX`` / ``DRIFT_MAX_MAX``
  (phase 11's gate), against rank 0's int8 run alone, and the launches of
  one prefill (K1 on every tower and decoder layer, K5 at every site, no
  bf16-P attention); a 16-request int8 drain whose first tokens are rank 0
  alone's (at least ``SERVE_FIRST_MIN`` of them, phase 12's share);
- ``tp_moe``: tensor=2 x expert=2 (four ranks): one MoE layer against the
  unsharded one (outputs, aux, drops against a host count), then the MoE
  model at ``TP_MOE_LAYERS`` layers, 3 steps, the first within ``LOSS_RTOL``
  of rank 0 alone's (after an update the top-k flips tokens near a tie);
- ``offload``: ``host_offload_params`` under ZeRO-3 at fsdp = world and
  (four ranks) fsdp=2 x tensor=2, on the zero modes' rows (grad_accum 2), 3
  steps each: loss and grad_norm bitwise those of the same mesh without it
  (run just before, in the same process), device memory between steps at
  most ``OFFLOAD_BETWEEN_MAX`` a card, the step's peak at most the mesh's
  without offload (plus ``OFFLOAD_PEAK_SLACK``); H2D and D2H ms a step and
  a card.

Rank 0 prints one JSON line (with ``failed_gates``), and writes it to
``--out``; on the cards it also holds, after each mode, what each card
holds outside PyTorch's allocator (the CUDA context and the NCCL
communicators). Each mode destroys its mesh's process groups when it is
done (:func:`release`).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import time

import numpy as np
import torch
import torch.distributed as dist

from ..models.configs import aki_4b, aki_tiny
from .mesh import MeshConfig, init_distributed

MODES = ("zero3", "zero2", "ckpt", "tp", "sp", "pp", "ep", "tp_train", "tp_seq", "tp_f32",
         "tp_w8a8", "tp_moe", "offload")
TP_TRAIN = ("tp_train", "tp_seq")
LOSS_RTOL = 1e-2            # bf16 on the cards; 1e-4 in fp32 on the CPU
F32_RTOL = 1e-4             # tp_f32: fp32 on both sides, as the CPU tests' gate
F32_LAYERS = 8              # tp_f32's decoder depth (the widths stay the model's)
F32_ROW_SEEDS = (3, 5)      # tp_train's rows, and a second draw
TP_MOE_LAYERS = 4           # tp_moe's decoder depth
DRIFT_MEAN_MAX, DRIFT_MAX_MAX = 0.25, 2.0   # chip_smoke.py phase 11's int8 drift gate
SERVE_FIRST_MIN = 0.5       # share of first tokens equal to one card's (phase 12: 4 of 8)
# offload: a card's memory between offloaded steps (what is not state: one
# card's 0.106 GB of chip_smoke.py phase 17, PR 12, and 0.1 GB of room), and
# what the offloaded step's peak may exceed the same mesh's without offload
OFFLOAD_BETWEEN_MAX = 0.206e9
OFFLOAD_PEAK_SLACK = 0.1e9


def log(*args) -> None:
    if dist.get_rank() == 0:
        print(*args, flush=True)


def rows(cfg, n_txt: int, seed: int, pad_second: bool = True):
    """Two training rows as a loader gives them: <s> <|user|> <image>
    question <|end|> <|assistant|> answer <|end|>, labels on the answer; the
    second row right-padded after 3/4 of its text. Drawn from ``seed``
    (host numpy), the same on every rank."""
    from ..train.step import Batch

    rng = np.random.RandomState(seed)
    n_q = n_txt // 3
    ids = np.stack([np.concatenate([
        [1, 32010 % cfg.initial_tokenizer_len, cfg.media_token_id],
        rng.randint(5, cfg.initial_tokenizer_len - 1, n_q),
        [cfg.assistant_token_id], rng.randint(5, cfg.initial_tokenizer_len - 1,
                                               n_txt - n_q - 4)]) for _ in range(2)])
    ids = ids.astype(np.int32)
    labels = ids.astype(np.int64).copy()
    labels[:, : n_q + 4] = -100
    valid = np.ones_like(ids)
    if pad_second:
        cut = 3 * n_txt // 4
        valid[1, cut:] = 0
        ids[1, cut:] = cfg.pad_token_id
        labels[1, cut:] = -100
    s = cfg.siglip.image_size
    images = (rng.rand(2, s, s, 3) * 2 - 1).astype(np.float32)
    return Batch(ids, images, valid, labels)


def tile(batch, n: int):
    """The batch repeated ``n`` times along its rows (every rank's rows)."""
    from ..train.step import Batch

    rep = lambda x: np.concatenate([x] * n)  # noqa: E731
    return Batch(rep(batch.input_ids), rep(batch.images), rep(batch.attn_valid),
                 rep(batch.labels))


class _Quiet:
    last = None

    def log(self, step, **scalars):
        self.last = {"step": step, **{k: float(v) for k, v in scalars.items()}}

    def close(self):
        pass


def gather_objects(x) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, x)
    return out


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def run_config(args, run_dir, **kw):
    from ..train.runner import RunnerConfig

    return RunnerConfig(run_dir=run_dir, precision=args.precision, remat=True,
                        frozen_bf16=args.precision == "bf16", warmup_steps=0,
                        learning_rate=1e-4, total_steps=1000, checkpoint_steps=10 ** 9,
                        log_every=1, seed=4, **kw)


def launches() -> dict[str, int]:
    """The port kernels' launch counters (they count on the cards only)."""
    from ..ops import fused_quant
    from ..ops.decode_attention import decode_attention_flat
    from ..ops.flash_mma import flash_mma_attention
    from ..ops.flash_mma_bwd import run_backward

    return {"fwd": flash_mma_attention.launches, "dq": run_backward.dq_launches,
            "dkv": run_backward.dkv_launches, "decode": decode_attention_flat.launches,
            **{f.__name__: f.launches for f in fused_quant.FUSED_QUANT_FUNCTIONS}}


def zero_launches() -> None:
    from ..ops import fused_quant
    from ..ops.decode_attention import decode_attention_flat
    from ..ops.flash_mma import flash_mma_attention
    from ..ops.flash_mma_bwd import run_backward

    flash_mma_attention.launches = decode_attention_flat.launches = 0
    run_backward.dq_launches = run_backward.dkv_launches = 0
    for f in fused_quant.FUSED_QUANT_FUNCTIONS:
        f.launches = 0


def steps(trainer, micro, n: int, device, grad_accum: int) -> list[dict]:
    out = []
    for _ in range(n):
        sync(device)
        zero_launches()
        t0 = time.perf_counter()
        trainer.run_epoch(iter([micro] * grad_accum if grad_accum > 1 else [micro]), 0)
        sync(device)
        rec = trainer.metrics.last
        n_l = launches()
        out.append(dict(loss=rec["training_loss"], grad_norm=rec["grad_norm"],
                        ms=(time.perf_counter() - t0) * 1e3,
                        launches={k: n_l[k] for k in ("fwd", "dq", "dkv")}))
    return out


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


FAILED: list[str] = []


def gate(ok: bool, what: str) -> None:
    """Record a failed gate, printed at once: the run goes on with its other
    modes and exits non-zero at the end (``main``)."""
    if not ok:
        FAILED.append(what)
        log(f"dryrun: GATE FAILED: {what}")


def zero_modes(args, ctx) -> dict:
    """ZeRO-3, ZeRO-2 and the checkpoint across meshes."""
    from ..train.runner import Trainer

    cfg, device, world, rank = ctx["cfg"], ctx["device"], ctx["world"], ctx["rank"]
    micro = rows(cfg, args.train_text, 1)
    out = {}
    ref = None
    if rank == 0:
        t = Trainer(cfg, run_config(args, ctx["dir"] + "/ref", grad_accum=2), device=device,
                    metrics=_Quiet(), distributed=False)
        ref = steps(t, micro, 3, device, 2)
        del t
        free(device)
    dist.barrier()
    ref = gather_objects(ref)[0]
    out["one_card"] = ref
    log(f"zero reference (rank 0 alone, 2 rows x grad_accum 2): {ref}")
    big = tile(micro, world)
    for mode, strategy in (("zero3", "full"), ("zero2", "grad_op")):
        if mode not in args.modes and not (mode == "zero3" and args.zero_ckpt):
            continue
        free(device)
        t = Trainer(cfg, run_config(args, ctx["dir"] + f"/{mode}", grad_accum=2,
                                    mesh=MeshConfig(fsdp=world), fsdp_strategy=strategy),
                    device=device, metrics=_Quiet())
        got = steps(t, big, 3, device, 2)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        res = dict(steps=got, peak_bytes_per_card=gather_objects(peak),
                   loss_rel=[rel(g["loss"], r["loss"]) for g, r in zip(got, ref)],
                   grad_norm_rel=[rel(g["grad_norm"], r["grad_norm"])
                                  for g, r in zip(got, ref)])
        log(f"{mode} (fsdp={world}, {strategy}): {res}")
        gate(max(res["loss_rel"] + res["grad_norm_rel"]) <= args.loss_rtol,
             f"{mode} loss/grad_norm differ from rank 0 alone: {res}")
        if mode == "zero2" and "zero3" in out:
            z3 = out["zero3"]["steps"]
            res["vs_zero3_rel"] = [max(rel(g["loss"], w["loss"]),
                                       rel(g["grad_norm"], w["grad_norm"]))
                                   for g, w in zip(got, z3)]
            gate(max(res["vs_zero3_rel"]) <= args.loss_rtol, "zero2 differs from zero3")
        if mode == "zero3" and args.zero_ckpt:
            out["ckpt"] = restore_on_one_card(args, ctx, t, f"fsdp={world}", grad_accum=2)
        else:
            release(t.mesh)
            del t
        if mode in args.modes:
            out[mode] = res
    free(device)
    return out


def moments(trainer, keep: bool) -> dict:
    """The AdamW moments of ``trainer`` whole, by (parameter name, key), on
    the host where ``keep`` (a gather of each sharded one and of its tensor
    block: every rank calls)."""
    from ..train.checkpoints import model_shards, whole

    names = {id(p): n for n, p in trainer.model.named_parameters()}
    shards = model_shards(trainer.model)
    opt = trainer.state.optimizer.opt
    out = {}
    for g in opt.param_groups:
        for p in g["params"]:
            for k in ("exp_avg", "exp_avg_sq"):
                if k in opt.state.get(p, {}):
                    t = whole(opt.state[p][k], shards, names[id(p)])
                    if keep:
                        out[(names[id(p)], k)] = t.detach().cpu()
    return out


def restore_on_one_card(args, ctx, t, label: str, grad_accum: int = 1) -> dict:
    """Save the sharded Trainer ``t``'s state (gathered, rank 0 writes),
    release its mesh, restore the run dir on rank 0 alone and hold every
    weight and AdamW moment to the saved ones bitwise; ``t`` has run 3
    steps."""
    from ..train.checkpoints import model_shards, whole
    from ..train.runner import Trainer

    cfg, device, rank = ctx["cfg"], ctx["device"], ctx["rank"]
    t0 = time.perf_counter()
    path = t.ckpt.save(t.state, epoch=0, include_frozen=True)
    save_s = time.perf_counter() - t0
    want = {}
    shards = model_shards(t.model)
    for k, v in t.model.state_dict().items():
        w = whole(v, shards, k)                 # a gather: every rank calls
        if rank == 0:
            want[k] = w.detach().cpu()
    want_moments = moments(t, rank == 0)
    release(t.mesh)
    t.state = None                          # the caller's Trainer lets go of the model
    free(device)
    ck = None
    if rank == 0:
        t0 = time.perf_counter()
        r = Trainer(cfg, run_config(args, os.path.dirname(path), grad_accum=grad_accum,
                                    training_mode="resume"),
                    device=device, metrics=_Quiet(), distributed=False)
        load_s = time.perf_counter() - t0
        live = r.model.state_dict()
        bad = [k for k, v in want.items() if not torch.equal(live[k].cpu(), v)]
        got_moments = moments(r, True)
        bad_m = [k for k, v in want_moments.items()
                 if k not in got_moments or not torch.equal(got_moments[k], v)]
        ck = dict(path=os.path.basename(path), bytes=os.path.getsize(path),
                  save_s=save_s, restore_s=load_s, tensors=len(want),
                  mismatched=bad[:5], moments=len(want_moments),
                  moments_restored=len(got_moments), mismatched_moments=bad_m[:5],
                  step=r.state.step, adam_count=r.state.optimizer.count)
        del r, live, want, want_moments, got_moments
        free(device)
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    dist.barrier()
    ck = gather_objects(ck)[0]
    log(f"ckpt ({label} -> one card): {ck}")
    gate(not ck["mismatched"] and not ck["mismatched_moments"] and ck["step"] == 3
         and ck["adam_count"] == 3 and ck["moments"] == ck["moments_restored"] > 0,
         f"checkpoint restore ({label}): {ck}")
    return ck


def release(mesh) -> None:
    """Destroy ``mesh``'s process groups (every rank calls it, once the
    mode is done with them). Each mode builds its own mesh, and one process
    would otherwise keep every mode's NCCL communicators to its end."""
    from torch.distributed.distributed_c10d import GroupMember

    groups = {id(g): g for g in mesh.device_mesh.get_all_groups()}
    groups.update({id(g): g for g in mesh._groups.values()})
    for g in groups.values():
        if g is not GroupMember.WORLD:
            dist.destroy_process_group(g)


def non_torch_bytes(device) -> int:
    """What the card holds outside PyTorch's allocator (the CUDA context,
    NCCL's communicators and their buffers): in use on the card less what
    the allocator reserved. 0 on the CPU."""
    if device.type != "cuda":
        return 0
    free_b, total = torch.cuda.mem_get_info(device)
    return total - free_b - torch.cuda.memory_reserved(device)


def tp_mode(args, ctx) -> dict:
    """Tensor-parallel serving against rank 0's one-card run."""
    from ..infer import engine
    from ..infer.server import ServingEngine
    from ..models.aki import AKIModel
    from ..ops.decode_attention import decode_attention_flat
    from ..ops.flash_mma import flash_mma_attention
    from .mesh import Mesh

    cfg, device, world, rank = ctx["cfg"], ctx["device"], ctx["world"], ctx["rank"]
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    from ..models.common import BF16, F32

    policy = BF16 if args.precision == "bf16" else F32
    ids, image, valid, reqs = tp_requests(cfg, args)
    max_len = args.max_len

    def build():
        return AKIModel(cfg, device=device, dtype=dtype,
                        generator=torch.Generator(device=device).manual_seed(0))

    def drain(model, **kw):
        eng = ServingEngine(model, num_slots=8, max_len=max_len, prompt_bucket=args.serve_text,
                            admit_batch=8, decode_chunk=4, policy=policy, kv_int8=True,
                            device=device, **kw)
        handles = [eng.submit(r_ids, img, max_new_tokens=m) for r_ids, img, m in reqs]
        eng.run_until_drained()
        eng.close()
        return [h.result(timeout=600) for h in handles]

    one = None
    if rank == 0:
        model = build()
        model.requires_grad_(False)
        st = engine.prefill(model, ids, image, valid, max_len, policy=policy, device=device)
        toks, _ = engine.generate(model, ids, image, valid, 16, max_len, policy=policy,
                                  device=device)
        one = dict(logits=st.last_logits.float().cpu(), tokens=toks.cpu().tolist(),
                   served=drain(model))
        del model, st
        free(device)
    dist.barrier()
    one = gather_objects(one)[0]
    mesh = Mesh(MeshConfig(fsdp=1, tensor=world), device.type)
    model = build()
    model.requires_grad_(False)
    flash_mma_attention.launches = decode_attention_flat.launches = 0
    st = engine.prefill(model, ids, image, valid, max_len, policy=policy, device=device,
                        tp_mesh=mesh)
    toks, _ = engine.generate(model, ids, image, valid, 16, max_len, policy=policy,
                              device=device)
    k1_generate = flash_mma_attention.launches
    decode_attention_flat.launches = 0
    served = drain(model, tp_mesh=mesh)
    k4_drain = decode_attention_flat.launches
    logits = st.last_logits.float().cpu()
    cos = torch.nn.functional.cosine_similarity(logits.double().flatten(),
                                                one["logits"].double().flatten(), dim=0).item()
    same_argmax = bool((logits.argmax(-1) == one["logits"].argmax(-1)).all())
    agree = sum(a == b for a, b in zip(toks.cpu().tolist()[0], one["tokens"][0]))
    served_same = sum(a == b for a, b in zip(served, one["served"]))
    first_same = sum(a[:1] == b[:1] for a, b in zip(served, one["served"]))
    res = dict(prefill_cosine=cos, same_argmax=same_argmax, tokens_agree=agree,
               tokens=16, served_identical=served_same, served_first_identical=first_same,
               requests=len(reqs), k1_launches_generate=k1_generate,
               k4_launches_drain=k4_drain,
               kv_heads_per_rank=cfg.phi3.num_kv_heads // world)
    log(f"tp (tensor={world}): {res}")
    gate(cos >= 0.995 and same_argmax, f"tp prefill logits differ from one card: {res}")
    gate(device.type != "cuda" or (k1_generate > 0 and k4_drain > 0),
         f"tp: the kernels were not launched: {res}")
    release(mesh)
    del model, st
    free(device)
    return res


def sp_mode(args, ctx) -> dict:
    """Sequence parallelism by the ring and the all-gather, against rank 0
    alone."""
    from ..ops import ring_attention
    from ..train.runner import Trainer

    cfg, device, world, rank = ctx["cfg"], ctx["device"], ctx["world"], ctx["rank"]
    n_txt = args.sp_tokens - cfg.perceiver.num_latents + 1
    micro = rows(cfg, n_txt, 2)
    ref = None
    if rank == 0:
        t = Trainer(cfg, run_config(args, ctx["dir"] + "/sp_ref"), device=device,
                    metrics=_Quiet(), distributed=False)
        ref = steps(t, micro, 1, device, 1)[0]
        del t
        free(device)
    dist.barrier()
    ref = gather_objects(ref)[0]
    out = {"one_card": ref}
    for impl in ("ring", "allgather"):
        ring_attention.SP_IMPL = impl
        free(device)
        t = Trainer(cfg, run_config(args, ctx["dir"] + f"/sp_{impl}",
                                    mesh=MeshConfig(fsdp=1, seq=world)),
                    device=device, metrics=_Quiet())
        got = steps(t, micro, 1, device, 1)[0]
        shard = ring_attention.LAST_SHARD if world > 1 else None   # seq=1: no shard
        ph = cfg.phi3
        kv_rows = max(shard.seen_kv_rows) if shard is not None else args.sp_tokens
        kv_bytes = 2 * 2 * kv_rows * ph.num_kv_heads * ph.head_dim * (
            2 if args.precision == "bf16" else 4)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        res = dict(step=got, loss_rel=rel(got["loss"], ref["loss"]),
                   grad_norm_rel=rel(got["grad_norm"], ref["grad_norm"]),
                   tokens=args.sp_tokens, rows_per_rank=args.sp_tokens // world,
                   kv_rows_per_rank=kv_rows,
                   kv_bytes_per_layer_per_rank=kv_bytes,
                   peak_bytes_per_card=gather_objects(peak))
        log(f"sp {impl} (seq={world}): {res}")
        gate(max(res["loss_rel"], res["grad_norm_rel"]) <= args.loss_rtol,
             f"sp {impl} differs from rank 0 alone: {res}")
        out[impl] = res
        release(t.mesh)
        del t
    ring_attention.SP_IMPL = "ring"
    free(device)
    return out


def pp_mode(args, ctx, ref) -> dict:
    """Pipeline: ``pipe`` = world, ``pp_microbatches`` = world, ``world``
    rows (copies of the zero modes' two rows: their loss and gradient), 3
    steps against rank 0 alone on the two rows (the zero modes' reference)."""
    from ..train.runner import Trainer

    cfg, device, world = ctx["cfg"], ctx["device"], ctx["world"]
    micro = rows(cfg, args.train_text, 1)
    free(device)
    t = Trainer(cfg, run_config(args, ctx["dir"] + "/pp", mesh=MeshConfig(fsdp=1, pipe=world),
                                pp_microbatches=world),
                device=device, metrics=_Quiet())
    pipe = t.model.lang_model.model.pipe
    layers = list(pipe.layers) if pipe is not None else range(cfg.phi3.num_layers)
    got = steps(t, tile(micro, max(1, world // 2)), 3, device, 1)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    res = dict(steps=got, layers_per_stage=len(layers), microbatches=world,
               peak_bytes_per_card=gather_objects(peak),
               loss_rel=[rel(g["loss"], r["loss"]) for g, r in zip(got, ref)],
               grad_norm_rel=[rel(g["grad_norm"], r["grad_norm"]) for g, r in zip(got, ref)])
    log(f"pp (pipe={world}, {world} microbatches): {res}")
    gate(max(res["loss_rel"] + res["grad_norm_rel"]) <= args.loss_rtol,
         f"pp differs from rank 0 alone: {res}")
    release(t.mesh)
    del t
    free(device)
    return res


def host_drops(top_idx, top_p, e: int, cap: int) -> int:
    """The dropped (token, choice) pairs counted on the host, choice-major."""
    seen, dropped = [0] * e, 0
    for j in range(top_idx.shape[1]):
        for n in range(top_idx.shape[0]):
            x = int(top_idx[n, j])
            dropped += not (seen[x] < cap and float(top_p[n, j]) > 0)
            seen[x] += 1
    return dropped


def ep_meshes(world: int) -> dict[str, MeshConfig]:
    """The ep mode's meshes: every rank an expert block over the same
    tokens, and (on an even world) the tokens split over ``data`` as well."""
    out = {f"ep{world}": MeshConfig(fsdp=1, expert=world)}
    if world % 2 == 0 and world > 2:
        out[f"dp{world // 2}_ep2"] = MeshConfig(data=world // 2, fsdp=1, expert=2)
    return out


def ep_layer(ctx, mc, mesh_cfg, full, x) -> dict:
    """One MoE layer over ``mesh_cfg`` (its experts over ``expert``, their
    inner dim over ``tensor``) held to the unsharded layer ``full`` on
    every token ``x``; every rank runs both, and compares its own rows'
    outputs. The drops are summed over the ranks and counted
    again on the host."""
    from ..models.moe import MoEMLP, moe_mlp, route
    from .expert import moe_parallel
    from .mesh import BATCH_AXES, Mesh

    device = ctx["device"]
    d = x.shape[-1]
    mesh = Mesh(mesh_cfg, device.type)
    par = moe_parallel(mesh)
    n = mc.num_experts // par.ep_size
    ep = MoEMLP(d, mc, device=device, dtype=torch.float32)
    with torch.no_grad():
        ep.router.weight.copy_(full.router.weight)
        for w in ("w_gate", "w_up", "w_down"):
            ep.get_parameter(w).data = full.get_parameter(w)[par.ep_rank * n:
                                                             (par.ep_rank + 1) * n].clone()
    ep.par = par
    n_t = mesh.shape["tensor"]
    if n_t > 1:
        # the rank's block of every expert's inner dim (parallel/tensor.py)
        from .tensor import TensorParallel

        ep.tp = TensorParallel(mesh.group("tensor"), mesh.coord("tensor"), n_t)
        for w, dim in (("w_gate", 2), ("w_up", 2), ("w_down", 1)):
            p = ep.get_parameter(w)
            p.data = p.data.chunk(n_t, dim=dim)[ep.tp.rank].contiguous()
    rows = x.shape[0] // mesh.size(*BATCH_AXES)
    mine = slice(par.batch_index * rows, (par.batch_index + 1) * rows)
    with torch.no_grad():
        out, aux = moe_mlp(ep, x[mine], mc)
        r = route(ep, x[mine].reshape(-1, d), mc, par, rows=rows)
        want, want_aux = moe_mlp(full, x, mc)
        rh = route(full, x.reshape(-1, d), mc)
        # the expert and tensor ranks hold the same tokens: count on the first
        first = par.ep_rank == 0 and mesh.coord("tensor") == 0
        dropped = torch.tensor([int((~r.keep).sum()) if first else 0], device=device)
        dist.all_reduce(dropped)
        err = float((out.float() - want[mine].float()).abs().max())
    res = dict(mesh={k: v for k, v in mesh.shape.items() if v > 1}, tokens_split=par.tokens,
               max_abs_err=max(gather_objects(err)), max_abs=float(want.float().abs().max()),
               aux=float(aux), aux_one_card=float(want_aux), dropped=int(dropped),
               cap=r.cap, cap_one_card=rh.cap,
               dropped_host=host_drops(rh.top_idx.cpu(), rh.top_p.cpu(), mc.num_experts,
                                       rh.cap))
    release(mesh)
    return res


def ep_mode(args, ctx) -> dict:
    """Expert parallelism over each mesh of :func:`ep_meshes`. One MoE
    layer at the model's width (8 experts, top-2, capacity factor 1.25)
    held to the unsharded layer on every token (outputs within 1e-2 of
    their largest, the aux, the drops equal to a count on the host); then
    the MoE model cut to ``ep_layers`` layers trained 3 steps on each mesh
    from the same weights and rows: finite losses that fall, and each
    mesh's first step (the same weights) within ``LOSS_RTOL`` of the
    first mesh's in loss and grad norm."""
    from ..models.configs import MoEConfig
    from ..models.moe import MoEMLP
    from ..train.runner import Trainer

    cfg, device, world = ctx["cfg"], ctx["device"], ctx["world"]
    mc = MoEConfig(num_experts=8, top_k=2, intermediate_size=cfg.phi3.intermediate_size,
                   capacity_factor=1.25)
    if mc.num_experts % world:
        return {"ran": False, "why": f"8 experts do not split over {world} ranks"}
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    d = cfg.phi3.hidden_size
    gen = torch.Generator(device=device).manual_seed(11)
    full = MoEMLP(d, mc, device=device, dtype=torch.float32)
    full.reset_parameters(gen, cfg.phi3.initializer_range)
    x = (torch.randn(2, args.train_text + cfg.perceiver.num_latents - 1, d, device=device,
                     generator=gen) * 0.5).to(dtype)
    meshes = ep_meshes(world)
    out = {}
    for name, mesh_cfg in meshes.items():
        one = ep_layer(ctx, mc, mesh_cfg, full, x)
        log(f"ep layer ({name}): {one}")
        gate(one["max_abs_err"] <= 1e-2 * one["max_abs"]
             and one["dropped"] == one["dropped_host"] and one["cap"] == one["cap_one_card"]
             and abs(one["aux"] - one["aux_one_card"]) <= 1e-4 * abs(one["aux_one_card"]),
             f"ep layer ({name}) differs from one card: {one}")
        out[f"layer_{name}"] = one
    del full, x
    free(device)
    cfg_moe = dataclasses.replace(cfg, phi3=dataclasses.replace(
        cfg.phi3, num_layers=args.ep_layers, moe=mc))
    micro = rows(cfg, args.train_text, 1)
    first = None
    for name, mesh_cfg in meshes.items():
        t = Trainer(cfg_moe, run_config(args, ctx["dir"] + f"/{name}", grad_accum=2,
                                        mesh=mesh_cfg),
                    device=device, metrics=_Quiet())
        got = steps(t, micro, 3, device, 2)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        res = dict(steps=got, layers=args.ep_layers, peak_bytes_per_card=gather_objects(peak))
        losses = [g["loss"] for g in got]
        gate(all(np.isfinite(losses)) and losses[-1] < losses[0],
             f"ep training ({name}): {losses}")
        if first is None:
            first = got
        else:
            # step 1 runs both meshes on the same weights; after an update
            # the top-k is a step function, and the bf16 runs part as tokens
            # near a tie change experts (steps 2-3 are printed only)
            res["vs_first_rel"] = [max(rel(g["loss"], w["loss"]),
                                       rel(g["grad_norm"], w["grad_norm"]))
                                   for g, w in zip(got, first)]
            gate(res["vs_first_rel"][0] <= args.loss_rtol,
                 f"ep training ({name}) differs from {next(iter(meshes))}: {res}")
        held = gather_objects(non_torch_bytes(device))
        release(t.mesh)
        del t
        free(device)
        res["non_torch_bytes_per_card"] = dict(mesh_held=held, released=gather_objects(
            non_torch_bytes(device)))
        log(f"ep trainer ({name}, {args.ep_layers} layers): {res}")
        out[f"train_{name}"] = res
    return out


def peak(device) -> list:
    """Every card's peak allocated bytes since the last reset."""
    return gather_objects(torch.cuda.max_memory_allocated(device)
                          if device.type == "cuda" else 0)


def tp_train_modes(args, ctx) -> dict:
    """Training over ``tensor``: tensor = world, fsdp=2 x tensor=2 and
    tensor=2 x seq=2 by the ring and by the all-gather (four ranks), each 3
    steps on the same two rows against rank 0 alone; the fsdp=2 x tensor=2
    state restored on one card with ``ckpt``. Beside them, how far two
    bf16 implementations of one card part over the same steps: rank 0
    alone with the plain attention against its kernels' run."""
    from ..ops import ring_attention
    from ..train.runner import Trainer
    from ..train.step import make_train_step

    cfg, device, world, rank = ctx["cfg"], ctx["device"], ctx["world"], ctx["rank"]
    micro = rows(cfg, args.tp_train_text, 3)
    ref = plain = floor = None
    if rank == 0:
        runs = []
        for use_flash in (True, False):
            t = Trainer(cfg, run_config(args, ctx["dir"] + "/tp_ref"), device=device,
                        metrics=_Quiet(), distributed=False)
            if not use_flash:
                t.step_fn = make_train_step(cfg, policy=t.policy, remat=True, use_flash=False,
                                            device=device)
            runs.append(steps(t, micro, 3, device, 1))
            del t
            free(device)
        ref, plain = runs
        floor = dict(loss_rel=[rel(p["loss"], r["loss"]) for p, r in zip(plain, ref)],
                     grad_norm_rel=[rel(p["grad_norm"], r["grad_norm"])
                                    for p, r in zip(plain, ref)])
    dist.barrier()
    ref, plain, floor = gather_objects((ref, plain, floor))[0]
    bounds = parting_bounds(floor, args.loss_rtol)
    spliced = args.tp_train_text + cfg.perceiver.num_latents - 1
    out = {"one_card": ref, "one_card_plain": plain, "one_card_plain_vs_kernels": floor,
           "bounds": bounds, "spliced_tokens": spliced}
    log(f"tp training reference (rank 0 alone, 2 rows x {spliced} spliced tokens): {ref}; "
        f"the plain attention's run against it: {floor}")
    meshes = []
    if "tp_train" in args.modes:
        meshes.append((f"tp{world}", dict(fsdp=1, tensor=world), micro, None))
        if world == 4:
            meshes.append(("fsdp2_tp2", dict(fsdp=2, tensor=2), tile(micro, 2), None))
    if "tp_seq" in args.modes and world == 4:
        for impl in ("ring", "allgather"):
            meshes.append((f"tp2_seq2_{impl}", dict(fsdp=1, tensor=2, seq=2), micro, impl))
    for name, mesh, batch, impl in meshes:
        ring_attention.SP_IMPL = impl or "ring"
        free(device)
        t = Trainer(cfg, run_config(args, ctx["dir"] + f"/{name}", mesh=MeshConfig(**mesh)),
                    device=device, metrics=_Quiet())
        got = steps(t, batch, 3, device, 1)
        # the ring attends with plain block attention: it is held to one
        # card's plain run, the kernel routes to its kernels' run
        base = plain if impl == "ring" else ref
        fixed = [max(rel(g["loss"], r["loss"]), rel(g["grad_norm"], r["grad_norm"]))
                 for g, r in zip(got, ref)]
        res = dict(steps=got, peak_bytes_per_card=peak(device),
                   held_to="one card, plain attention" if impl == "ring" else
                   "one card, kernels",
                   loss_rel=[rel(g["loss"], r["loss"]) for g, r in zip(got, base)],
                   grad_norm_rel=[rel(g["grad_norm"], r["grad_norm"])
                                  for g, r in zip(got, base)],
                   fixed_bound=dict(vs_kernels_rel=fixed, rtol=args.loss_rtol,
                                    ok=max(fixed) <= args.loss_rtol),
                   heads_per_rank=dict(decoder=t.model.lang_model.model.cfg.num_heads,
                                       tower=cfg.siglip.num_heads // mesh["tensor"]
                                       if t.model.vision_encoder.tp else cfg.siglip.num_heads,
                                       perceiver=cfg.perceiver.heads // mesh["tensor"]
                                       if t.model.vision_tokenizer.tp else cfg.perceiver.heads),
                   rows_per_rank=int(t.put_batch(batch).input_ids.shape[0]))
        res["ok"] = all(r <= b for m in ("loss", "grad_norm")
                        for r, b in zip(res[f"{m}_rel"], bounds[m]))
        log(f"{name} ({mesh}): {res}; held to {res['held_to']} within {bounds} (the "
            f"fixed bound {args.loss_rtol} against the kernels' run at every step: "
            f"{'held' if res['fixed_bound']['ok'] else 'not held'}, {fixed})")
        gate(res["ok"], f"{name} loss/grad_norm differ from rank 0 alone: {res}")
        # the ring attends with plain block attention: the kernels run in the
        # tower only
        want = ([{"fwd": cfg.siglip.num_layers, "dq": 0, "dkv": 0}] * 3 if impl == "ring"
                else [r["launches"] for r in ref])
        gate(device.type != "cuda" or [g["launches"] for g in got] == want,
             f"{name}: K1/dq/dkv launches a step differ from {want}: {res}")
        if name == "fsdp2_tp2" and "ckpt" in args.modes:
            res["ckpt"] = restore_on_one_card(args, ctx, t, "fsdp=2 x tensor=2")
        else:
            release(t.mesh)
        del t
        out[name] = res
    ring_attention.SP_IMPL = "ring"
    free(device)
    return out


def parting_bounds(floor: dict, rtol: float) -> dict[str, list[float]]:
    """The bound of each step and metric: ``rtol`` at step 1; at later
    steps twice one card's plain-vs-kernels parting there, or ``rtol``
    where that is larger."""
    return {m: [rtol] + [max(rtol, 2 * f) for f in floor[f"{m}_rel"][1:]]
            for m in ("loss", "grad_norm")}


def offload_mode(args, ctx) -> dict:
    """``host_offload_params`` under ZeRO-3 at fsdp = world and (four ranks)
    fsdp=2 x tensor=2, each against the same mesh without it."""
    from ..train.runner import Trainer

    cfg, device, world = ctx["cfg"], ctx["device"], ctx["world"]
    micro = rows(cfg, args.train_text, 1)
    meshes = [(f"fsdp{world}", dict(fsdp=world), world)]
    if world == 4:
        meshes.append(("fsdp2_tp2", dict(fsdp=2, tensor=2), 2))
    out = {"between_max_bytes": OFFLOAD_BETWEEN_MAX}
    for name, mesh, batch_ranks in meshes:
        batch = tile(micro, batch_ranks)
        res = {}
        for label, offload in (("plain", False), ("offload", True)):
            free(device)
            t = Trainer(cfg, run_config(args, ctx["dir"] + f"/offload_{name}_{label}",
                                        grad_accum=2, mesh=MeshConfig(**mesh),
                                        host_offload_params=offload),
                        device=device, metrics=_Quiet())
            got = []
            for _ in range(3):
                st = steps(t, batch, 1, device, 2)[0]
                st.update(peak_bytes_per_card=peak(device),
                          between_bytes_per_card=gather_objects(
                              torch.cuda.memory_allocated(device) if device.type == "cuda"
                              else 0))
                if offload:
                    st["h2d_d2h_ms_per_card"] = gather_objects(t.offload_ms[-1])
                    st["state_on_host"] = all(gather_objects(all(
                        s_.nbytes() == 0 for s_ in t.state.offload.storages())))
                got.append(st)
                free(device)
            res[label] = got
            release(t.mesh)
            del t
            free(device)
        plain, off = res["plain"], res["offload"]
        res["bitwise"] = all(o["loss"] == p["loss"] and o["grad_norm"] == p["grad_norm"]
                             for o, p in zip(off, plain))
        res["between_ok"] = all(max(o["between_bytes_per_card"]) <= OFFLOAD_BETWEEN_MAX
                                and o["state_on_host"] for o in off)
        res["peak_ok"] = all(max(o["peak_bytes_per_card"])
                             <= max(p["peak_bytes_per_card"]) + OFFLOAD_PEAK_SLACK
                             for o, p in zip(off, plain))
        log(f"offload {name} ({mesh}, ZeRO-3): " + "; ".join(
            f"step {i + 1}: loss {o['loss']!r} / {p['loss']!r} grad_norm {o['grad_norm']!r} "
            f"/ {p['grad_norm']!r} between_gb {[b / 1e9 for b in o['between_bytes_per_card']]}"
            f" peak_gb {[b / 1e9 for b in o['peak_bytes_per_card']]} (without offload "
            f"{[b / 1e9 for b in p['peak_bytes_per_card']]}) h2d/d2h ms "
            f"{o['h2d_d2h_ms_per_card']}" for i, (o, p) in enumerate(zip(off, plain)))
            + f"; bitwise={res['bitwise']} between_ok={res['between_ok']} "
            f"peak_ok={res['peak_ok']}")
        gate(res["bitwise"], f"offload {name}: the numbers differ from the mesh without it")
        gate(res["between_ok"], f"offload {name}: state or more than {OFFLOAD_BETWEEN_MAX} "
             "bytes on a card between steps")
        gate(res["peak_ok"], f"offload {name}: the step's peak exceeds the mesh's without it")
        out[name] = res
    return out


def tp_f32_mode(args, ctx) -> dict:
    """The tensor = world and (four ranks) tensor=2 x seq=2 ring meshes in
    fp32 with the plain attention, at ``F32_LAYERS`` decoder layers, on each
    draw of rows in ``F32_ROW_SEEDS``: 3 steps against rank 0 alone (fp32,
    plain attention) within ``F32_RTOL``. A fault of the split shows here
    above fp32's rounding; bf16's parting of ``tp_train`` does not."""
    from ..ops import ring_attention
    from ..train.runner import Trainer
    from ..train.step import make_train_step

    device, world, rank = ctx["device"], ctx["world"], ctx["rank"]
    cfg = dataclasses.replace(ctx["cfg"], phi3=dataclasses.replace(
        ctx["cfg"].phi3, num_layers=F32_LAYERS))
    f32 = argparse.Namespace(**{**vars(args), "precision": "fp32"})
    meshes = [(f"tp{world}", dict(fsdp=1, tensor=world))]
    if world == 4:
        meshes.append(("tp2_seq2_ring", dict(fsdp=1, tensor=2, seq=2)))
    ring_attention.SP_IMPL = "ring"

    def plain(t):
        t.step_fn = make_train_step(cfg, policy=t.policy, remat=True, use_flash=False,
                                    device=device, parallel=t.parallel)
        return t

    out = {"layers": F32_LAYERS, "rtol": F32_RTOL}
    for seed in F32_ROW_SEEDS:
        micro = rows(cfg, args.tp_train_text, seed)
        ref = None
        if rank == 0:
            t = plain(Trainer(cfg, run_config(f32, ctx["dir"] + f"/f32_ref{seed}"),
                              device=device, metrics=_Quiet(), distributed=False))
            ref = steps(t, micro, 3, device, 1)
            del t
            free(device)
        dist.barrier()
        ref = gather_objects(ref)[0]
        rec = out[f"rows{seed}"] = {"one_card": ref}
        for name, mesh in meshes:
            t = plain(Trainer(cfg, run_config(f32, ctx["dir"] + f"/f32_{name}{seed}",
                                              mesh=MeshConfig(**mesh)),
                              device=device, metrics=_Quiet()))
            got = steps(t, micro, 3, device, 1)
            res = dict(steps=got, peak_bytes_per_card=peak(device),
                       loss_rel=[rel(g["loss"], r["loss"]) for g, r in zip(got, ref)],
                       grad_norm_rel=[rel(g["grad_norm"], r["grad_norm"])
                                      for g, r in zip(got, ref)])
            log(f"tp_f32 {name} (rows {seed}, {F32_LAYERS} layers): {res}")
            gate(max(res["loss_rel"] + res["grad_norm_rel"]) <= F32_RTOL,
                 f"tp_f32 {name} (rows {seed}) differs from rank 0 alone: {res}")
            release(t.mesh)
            del t
            free(device)
            rec[name] = res
    return out


def logit_drift(a: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """Mean and largest |a - ref| over the standard deviation of ``ref``."""
    d, sd = (a.float() - ref.float()).abs(), ref.float().std()
    return (d.mean() / sd).item(), (d.max() / sd).item()


def tp_w8a8_mode(args, ctx) -> dict:
    """W8A8 weights and the int8 KV cache at ``tensor`` = world against rank
    0 alone on the same weights."""
    from ..infer import engine
    from ..infer.server import ServingEngine
    from ..models.aki import AKIModel
    from ..models.common import BF16, F32
    from ..models.quant import quantize_params
    from .mesh import Mesh

    cfg, device, world, rank = ctx["cfg"], ctx["device"], ctx["world"], ctx["rank"]
    ids, image, valid, reqs = tp_requests(cfg, args)
    policy = BF16 if args.precision == "bf16" else F32

    def build():
        model = AKIModel(cfg, device=device, dtype=torch.bfloat16 if policy is BF16
                         else torch.float32,
                         generator=torch.Generator(device=device).manual_seed(0))
        return model.requires_grad_(False)

    def drain(model, **kw):
        eng = ServingEngine(model, num_slots=8, max_len=args.max_len,
                            prompt_bucket=args.serve_text, admit_batch=8, decode_chunk=4,
                            policy=policy, kv_int8=True, device=device, **kw)
        handles = [eng.submit(r_ids, img, max_new_tokens=m) for r_ids, img, m in reqs]
        eng.run_until_drained()
        eng.close()
        return [h.result(timeout=600) for h in handles]

    args_p = (ids, image, valid, args.max_len)
    one = None
    if rank == 0:
        model = build()
        bf16 = engine.prefill(model, *args_p, policy=policy, device=device).last_logits
        model.float()
        f32 = engine.prefill(model, *args_p, policy=F32, use_flash=False,
                             device=device).last_logits
        model.to(torch.bfloat16 if policy is BF16 else torch.float32)
        quantize_params(model, "w8a8", vision=True)
        int8 = engine.prefill(model, *args_p, policy=policy, device=device,
                              kv_int8=True).last_logits
        one = dict(bf16=bf16.float().cpu(), f32=f32.float().cpu(), int8=int8.float().cpu(),
                   served=drain(model))
        del model, bf16, f32, int8
        free(device)
    dist.barrier()
    one = gather_objects(one)[0]
    mesh = Mesh(MeshConfig(fsdp=1, tensor=world), device.type)
    model = quantize_params(build(), "w8a8", vision=True)
    engine.use_tensor_parallel(model, mesh)
    free(device)
    sync(device)
    zero_launches()
    t0 = time.perf_counter()
    st = engine.prefill(model, *args_p, policy=policy, device=device, kv_int8=True)
    sync(device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = launches()
    logits = st.last_logits.float().cpu()
    zero_launches()
    t0 = time.perf_counter()
    served = drain(model)
    drain_s = time.perf_counter() - t0
    drain_launches = launches()
    d_bf16, d_f32 = logit_drift(logits, one["bf16"]), logit_drift(logits, one["f32"])
    cos = torch.nn.functional.cosine_similarity(logits.double().flatten(),
                                                one["int8"].double().flatten(), dim=0).item()
    first_same = sum(a[:1] == b[:1] for a, b in zip(served, one["served"]))
    p, sg = cfg.phi3, cfg.siglip
    want_prefill = {"fwd": sg.num_layers + p.num_layers, "layernorm_quant": 2 * sg.num_layers,
                    "gelu_quant": sg.num_layers, "rmsnorm_quant": 2 * p.num_layers,
                    "silu_mul_quant": p.num_layers}
    res = dict(drift_vs_bf16=d_bf16, drift_vs_f32=d_f32, cosine_vs_int8_one_card=cos,
               argmax_equal_int8_one_card=bool((logits.argmax(-1)
                                                == one["int8"].argmax(-1)).all()),
               prefill_ms=prefill_ms, prefill_launches=prefill_launches,
               served_first_identical=first_same,
               served_identical=sum(a == b for a, b in zip(served, one["served"])),
               requests=len(reqs), drain_s=drain_s, drain_launches=drain_launches,
               cache_kv_heads_per_rank=int(st.cache.ks.shape[-1]),
               heads_per_rank=dict(decoder=model.lang_model.model.cfg.num_heads,
                                   tower=sg.num_heads // world if model.vision_encoder.tp
                                   else sg.num_heads),
               peak_bytes_per_card=peak(device))
    log(f"tp_w8a8 (tensor={world}): {res}")
    gate(max(d_bf16[0], d_f32[0]) < DRIFT_MEAN_MAX and max(d_bf16[1], d_f32[1]) < DRIFT_MAX_MAX,
         f"tp_w8a8 prefill logits drift past phase 11's gate: {res}")
    gate(first_same >= SERVE_FIRST_MIN * len(reqs),
         f"tp_w8a8 served first tokens differ from one card's: {res}")
    gate(res["cache_kv_heads_per_rank"] == p.num_kv_heads // world,
         f"tp_w8a8: the int8 cache does not hold the rank's heads: {res}")
    gate(device.type != "cuda" or (
        {k: prefill_launches[k] for k in want_prefill} == want_prefill
        and prefill_launches["decode"] == 0 and drain_launches["decode"] > 0),
        f"tp_w8a8 launches differ from {want_prefill}: {res}")
    release(mesh)
    del model, st
    free(device)
    return res


def tp_requests(cfg, args):
    """The tp modes' prompt (one request of ``tp_text`` tokens with an
    image) and the 16 requests of their drains, drawn from seed 0."""
    rng = np.random.RandomState(0)
    n_txt = args.tp_text
    ids = np.concatenate([[1, 32010 % cfg.initial_tokenizer_len, cfg.media_token_id],
                          rng.randint(100, min(32000, cfg.initial_tokenizer_len - 1), n_txt - 5),
                          [32007 % cfg.initial_tokenizer_len, cfg.assistant_token_id]])[None]
    ids = ids.astype(np.int32)
    s = cfg.siglip.image_size
    image = (rng.rand(1, s, s, 3) * 2 - 1).astype(np.float32)
    valid = np.ones_like(ids)
    reqs = []
    for _ in range(16):
        m = int(rng.randint(args.serve_text // 2, args.serve_text))
        r_ids = rng.randint(5, cfg.initial_tokenizer_len - 1, size=m)
        r_ids[1] = cfg.media_token_id
        r_ids[min(40, m - 2)] = cfg.assistant_token_id
        reqs.append((r_ids.tolist(), (rng.rand(s, s, 3) * 2 - 1).astype(np.float32),
                     int(rng.randint(8, 17))))
    return ids, image, valid, reqs


def tp_moe_mode(args, ctx) -> dict:
    """The MoE decoder at tensor=2 x expert=2: one layer against the
    unsharded one, then the model at ``TP_MOE_LAYERS`` layers, 3 steps
    against rank 0 alone."""
    from ..models.configs import MoEConfig
    from ..models.moe import MoEMLP
    from ..train.runner import Trainer

    cfg, device, world, rank = ctx["cfg"], ctx["device"], ctx["world"], ctx["rank"]
    if world != 4:
        return {"ran": False, "why": "tensor=2 x expert=2 needs four ranks"}
    mc = MoEConfig(num_experts=8, top_k=2, intermediate_size=cfg.phi3.intermediate_size,
                   capacity_factor=1.25)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    d = cfg.phi3.hidden_size
    gen = torch.Generator(device=device).manual_seed(11)
    full = MoEMLP(d, mc, device=device, dtype=torch.float32)
    full.reset_parameters(gen, cfg.phi3.initializer_range)
    x = (torch.randn(2, args.train_text + cfg.perceiver.num_latents - 1, d, device=device,
                     generator=gen) * 0.5).to(dtype)
    mesh_cfg = MeshConfig(fsdp=1, tensor=2, expert=2)
    out = {"layer": ep_layer(ctx, mc, mesh_cfg, full, x)}
    one = out["layer"]
    log(f"tp_moe layer (tensor=2 x expert=2): {one}")
    gate(one["max_abs_err"] <= 1e-2 * one["max_abs"]
         and one["dropped"] == one["dropped_host"] and one["cap"] == one["cap_one_card"]
         and abs(one["aux"] - one["aux_one_card"]) <= 1e-4 * abs(one["aux_one_card"]),
         f"tp_moe layer differs from one card: {one}")
    del full, x
    free(device)
    cfg_moe = dataclasses.replace(cfg, phi3=dataclasses.replace(
        cfg.phi3, num_layers=TP_MOE_LAYERS, moe=mc))
    micro = rows(cfg, args.train_text, 1)
    ref = None
    if rank == 0:
        t = Trainer(cfg_moe, run_config(args, ctx["dir"] + "/tp_moe_ref", grad_accum=2),
                    device=device, metrics=_Quiet(), distributed=False)
        ref = steps(t, micro, 3, device, 2)
        del t
        free(device)
    dist.barrier()
    ref = gather_objects(ref)[0]
    t = Trainer(cfg_moe, run_config(args, ctx["dir"] + "/tp_moe", grad_accum=2,
                                    mesh=mesh_cfg),
                device=device, metrics=_Quiet())
    got = steps(t, micro, 3, device, 2)
    res = dict(one_card=ref, steps=got, layers=TP_MOE_LAYERS,
               peak_bytes_per_card=peak(device),
               vs_one_card_rel=[max(rel(g["loss"], w["loss"]), rel(g["grad_norm"], w["grad_norm"]))
                                for g, w in zip(got, ref)])
    log(f"tp_moe trainer (tensor=2 x expert=2, {TP_MOE_LAYERS} layers): {res}")
    losses = [g["loss"] for g in got]
    gate(all(np.isfinite(losses)) and losses[-1] < losses[0], f"tp_moe training: {losses}")
    gate(res["vs_one_card_rel"][0] <= args.loss_rtol,
         f"tp_moe step 1 differs from one card: {res}")
    release(t.mesh)
    del t
    free(device)
    out["train"] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--out", default=None)
    ap.add_argument("--sp-tokens", type=int, default=None,
                    help="spliced tokens a row of the sp mode (4,096 on the cards)")
    ap.add_argument("--ep-layers", type=int, default=8,
                    help="decoder layers of the ep mode's MoE model (8: ~30 GB a card at "
                         "expert=4)")
    args = ap.parse_args(argv)
    args.modes = [m for m in args.modes.split(",") if m]
    bad = set(args.modes) - set(MODES)
    if bad:
        raise SystemExit(f"dryrun: unknown modes {sorted(bad)}; choose from {MODES}")
    device = init_distributed(args.device, timeout_s=300.0)   # a stuck collective ends the run
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    # aki_tiny's decoder at 4 layers on the CPU, so that 4 stages each get one
    cfg = aki_4b() if cuda else dataclasses.replace(
        aki_tiny(), phi3=dataclasses.replace(aki_tiny().phi3, num_layers=4))
    # the rows: phase 8's 512 text tokens a row on the cards, tiny on the CPU
    args.precision = "bf16" if cuda else "fp32"
    args.loss_rtol = LOSS_RTOL if cuda else 1e-4
    args.train_text = 512 if cuda else 16
    args.sp_tokens = args.sp_tokens or (4096 if cuda else 4 * 8)
    args.tp_text, args.serve_text, args.max_len = (60, 512, 1024) if cuda else (12, 16, 48)
    # the tp training rows: an even spliced length, for seq=2
    args.tp_train_text = args.train_text + 1
    world, rank = dist.get_world_size(), dist.get_rank()
    run_dir = os.path.join(os.getcwd(), "build", "dryrun")
    ctx = dict(cfg=cfg, device=device, world=world, rank=rank, dir=run_dir)
    t_start = time.perf_counter()
    result = dict(world=world, device=torch.cuda.get_device_name(device) if cuda else "cpu",
                  config="aki_4b" if cuda else "aki_tiny", precision=args.precision,
                  modes=args.modes)
    if cuda and rank == 0:
        with contextlib.suppress(Exception):
            import subprocess

            result["card"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
    # sp first: its one-card reference (2 x 4,096 tokens beside the whole
    # training state) needs the card before the other modes' communicators
    # take their share of it
    # outside the allocator, a card, after each mode: the meshes' NCCL
    # communicators accumulate (each mode makes its own mesh)
    outside = result["non_torch_bytes_per_card"] = {"start": gather_objects(
        non_torch_bytes(device))}
    if "sp" in args.modes:
        result["sp"] = sp_mode(args, ctx)
        outside["sp"] = gather_objects(non_torch_bytes(device))
    # ckpt: ZeRO-3's state, unless only the tp training modes' is asked for
    args.zero_ckpt = "ckpt" in args.modes and ("zero3" in args.modes
                                               or "tp_train" not in args.modes)
    if {"zero3", "zero2", "pp"} & set(args.modes) or args.zero_ckpt:
        result.update(zero_modes(args, ctx))
        outside["zero"] = gather_objects(non_torch_bytes(device))
    if "pp" in args.modes:
        result["pp"] = pp_mode(args, ctx, result["one_card"])
        outside["pp"] = gather_objects(non_torch_bytes(device))
    if "ep" in args.modes:
        result["ep"] = ep_mode(args, ctx)
        outside["ep"] = gather_objects(non_torch_bytes(device))
    if "tp" in args.modes:
        result["tp"] = tp_mode(args, ctx)
        outside["tp"] = gather_objects(non_torch_bytes(device))
    if set(TP_TRAIN) & set(args.modes):
        result["tp_train"] = tp_train_modes(args, ctx)
        outside["tp_train"] = gather_objects(non_torch_bytes(device))
    if "tp_f32" in args.modes:
        result["tp_f32"] = tp_f32_mode(args, ctx)
        outside["tp_f32"] = gather_objects(non_torch_bytes(device))
    if "tp_w8a8" in args.modes:
        result["tp_w8a8"] = tp_w8a8_mode(args, ctx)
        outside["tp_w8a8"] = gather_objects(non_torch_bytes(device))
    if "tp_moe" in args.modes:
        result["tp_moe"] = tp_moe_mode(args, ctx)
        outside["tp_moe"] = gather_objects(non_torch_bytes(device))
    if "offload" in args.modes:
        result["offload"] = offload_mode(args, ctx)
        outside["offload"] = gather_objects(non_torch_bytes(device))
    log(f"outside the allocator, a card: {outside}")
    result["seconds"] = time.perf_counter() - t_start
    result["failed_gates"] = FAILED
    line = json.dumps(result, default=float)
    log(line)
    if rank == 0 and args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if FAILED:
        log(f"dryrun: {len(FAILED)} gate(s) failed: {FAILED}")
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        shutil.rmtree(run_dir, ignore_errors=True)
    return 1 if FAILED else 0


if __name__ == "__main__":
    raise SystemExit(main())

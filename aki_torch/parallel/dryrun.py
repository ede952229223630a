"""The multi-device modes, one step set each, on every rank of a group
(counterpart of ``__graft_entry__.py:dryrun_multichip``)::

    torchrun --standalone --nproc-per-node 4 -m aki_torch.parallel.dryrun \\
        [--device cuda|cpu] [--modes zero3,zero2,ckpt,tp,sp,pp,ep] [--out FILE]

On the cards (NCCL) the model is AKI-4B at full width in bf16; with
``--device cpu`` (gloo) it is ``aki_tiny`` with 4 decoder layers in fp32. Each mode is held to a
run of rank 0 alone on the same rows (``Trainer(distributed=False)``,
``engine.generate`` unsharded), and raises ``SystemExit`` when a gate fails:

- ``zero3`` / ``zero2``: ``fsdp`` = world, ``fsdp_strategy`` ``full`` /
  ``grad_op``; every rank's micro-batch is the same two rows, so the global
  batch is their copies and its loss is the two rows' (grad_accum 2, 3
  steps); loss and grad_norm against rank 0 alone within ``LOSS_RTOL``;
  peak memory per card and step ms;
- ``ckpt``: the ZeRO-3 state saved (gathered, rank 0 writes), restored on
  rank 0 alone, every weight and AdamW moment bitwise;
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
  the second mesh's first step against the first's.

Rank 0 prints one JSON line, and writes it to ``--out``; on the cards it
also holds, after each mode, what each card holds outside PyTorch's
allocator (the CUDA context and the NCCL communicators). Each mode
destroys its mesh's process groups when it is done (:func:`release`).
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

MODES = ("zero3", "zero2", "ckpt", "tp", "sp", "pp", "ep")
LOSS_RTOL = 1e-2            # bf16 on the cards; 1e-4 in fp32 on the CPU


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


def steps(trainer, micro, n: int, device, grad_accum: int) -> list[dict]:
    out = []
    for _ in range(n):
        sync(device)
        t0 = time.perf_counter()
        trainer.run_epoch(iter([micro] * grad_accum if grad_accum > 1 else [micro]), 0)
        sync(device)
        rec = trainer.metrics.last
        out.append(dict(loss=rec["training_loss"], grad_norm=rec["grad_norm"],
                        ms=(time.perf_counter() - t0) * 1e3))
    return out


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def gate(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"dryrun: {what}")


def zero_modes(args, ctx) -> dict:
    """ZeRO-3, ZeRO-2 and the checkpoint across meshes."""
    from ..train.checkpoints import full_tensor
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
        if mode not in args.modes and not (mode == "zero3" and "ckpt" in args.modes):
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
        if mode == "zero3" and "ckpt" in args.modes:
            t0 = time.perf_counter()
            path = t.ckpt.save(t.state, epoch=0, include_frozen=True)
            save_s = time.perf_counter() - t0
            want = {}
            for k, v in t.model.state_dict().items():
                whole = full_tensor(v)            # a gather: every rank calls
                if rank == 0:
                    want[k] = whole.detach().cpu()
            want_moments = moments(t, rank == 0)
            release(t.mesh)
            del t
            free(device)
            ck = None
            if rank == 0:
                t0 = time.perf_counter()
                r = Trainer(cfg, run_config(args, os.path.dirname(path), grad_accum=2,
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
            log(f"ckpt (fsdp={world} -> one card): {ck}")
            gate(not ck["mismatched"] and not ck["mismatched_moments"] and ck["step"] == 3
                 and ck["adam_count"] == 3 and ck["moments"] == ck["moments_restored"] > 0,
                 f"checkpoint restore: {ck}")
            out["ckpt"] = ck
        else:
            release(t.mesh)
            del t
        if mode in args.modes:
            out[mode] = res
    free(device)
    return out


def moments(trainer, keep: bool) -> dict:
    """The AdamW moments of ``trainer`` whole, by (parameter name, key), on
    the host where ``keep`` (a gather of each sharded one: every rank
    calls)."""
    from ..train.checkpoints import full_tensor

    names = {id(p): n for n, p in trainer.model.named_parameters()}
    opt = trainer.state.optimizer.opt
    out = {}
    for g in opt.param_groups:
        for p in g["params"]:
            for k in ("exp_avg", "exp_avg_sq"):
                if k in opt.state.get(p, {}):
                    whole = full_tensor(opt.state[p][k])
                    if keep:
                        out[(names[id(p)], k)] = whole.detach().cpu()
    return out


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
    for i in range(16):
        m = int(rng.randint(args.serve_text // 2, args.serve_text))
        r_ids = rng.randint(5, cfg.initial_tokenizer_len - 1, size=m)
        r_ids[1] = cfg.media_token_id
        r_ids[min(40, m - 2)] = cfg.assistant_token_id
        reqs.append((r_ids.tolist(), (rng.rand(s, s, 3) * 2 - 1).astype(np.float32),
                     int(rng.randint(8, 17))))
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
    """One MoE layer over ``mesh_cfg`` held to the unsharded layer
    ``full`` on every token ``x``; every rank runs both, and compares its
    own rows' outputs. The drops are summed over the ranks and counted
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
    rows = x.shape[0] // mesh.size(*BATCH_AXES)
    mine = slice(par.batch_index * rows, (par.batch_index + 1) * rows)
    with torch.no_grad():
        out, aux = moe_mlp(ep, x[mine], mc)
        r = route(ep, x[mine].reshape(-1, d), mc, par, rows=rows)
        want, want_aux = moe_mlp(full, x, mc)
        rh = route(full, x.reshape(-1, d), mc)
        # the expert ranks hold the same tokens: count on the first one
        dropped = torch.tensor([int((~r.keep).sum()) if par.ep_rank == 0 else 0],
                               device=device)
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
    if {"zero3", "zero2", "ckpt", "pp"} & set(args.modes):
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
    log(f"outside the allocator, a card: {outside}")
    result["seconds"] = time.perf_counter() - t_start
    line = json.dumps(result, default=float)
    log(line)
    if rank == 0 and args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        shutil.rmtree(run_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

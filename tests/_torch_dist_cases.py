"""The cases that ``tests/_torch_dist.run_group`` runs on gloo ranks, one
function per test module (every case of the module in one group). They
import ``aki_torch`` only; the weights come from the parent (the JAX tree
through ``aki_torch.convert.from_jax_params``, saved with ``torch.save``),
the inputs as numpy arrays. Each returns numpy results; rank 0 returns the
whole tensors that need a gather."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from aki_torch.models.aki import AKIModel
from aki_torch.models.configs import aki_tiny
from aki_torch.parallel.mesh import MeshConfig
from aki_torch.train.checkpoints import full_tensor
from aki_torch.train.runner import RunnerConfig, Trainer

CFG = aki_tiny()


class NoMetrics:
    last = None

    def log(self, step, **scalars):
        pass

    def close(self):
        pass


def load_model(weights: str) -> AKIModel:
    model = AKIModel(CFG, device="cpu")
    model.load_state_dict(torch.load(weights), strict=True)
    return model


def run_config(run_dir: str, **kw) -> RunnerConfig:
    """The runner settings of the JAX reference: constant lr 1e-3, wd 0.1,
    clip 1.0, fp32, remat."""
    return RunnerConfig(run_dir=run_dir, learning_rate=1e-3, lr_schedule="constant",
                        warmup_steps=0, weight_decay=0.1, grad_clip=1.0, precision="fp32",
                        remat=True, total_steps=100, log_every=1000, checkpoint_steps=1000,
                        **kw)


def numpy(t: torch.Tensor) -> np.ndarray:
    return full_tensor(t).detach().float().numpy().copy()


def train(trainer: Trainer, batch, steps: int = 3):
    """``steps`` steps on ``batch``: their metrics, and the (whole)
    gradients of the first."""
    from aki_torch.train.checkpoints import model_shards, whole

    shards = model_shards(trainer.model)
    metrics, grads = [], None
    for i in range(steps):
        m = trainer.step_fn(trainer.state, trainer.put_batch(batch))
        if i == 0:
            grads = {n: numpy(whole(p.grad, shards, n))
                     for n, p in trainer.model.named_parameters() if p.grad is not None}
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, grads


def state_numpy(trainer: Trainer) -> dict:
    """The whole weights and AdamW moments (gathered over their shards and
    their tensor and expert blocks: every rank calls)."""
    from aki_torch.train.checkpoints import model_shards, whole

    shards = model_shards(trainer.model)
    weights = {k: numpy(whole(v, shards, k)) for k, v in trainer.model.state_dict().items()}
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    moments = {}
    for p in trainer.state.optimizer.params:
        st = trainer.state.optimizer.opt.state.get(p, {})
        for k in ("exp_avg", "exp_avg_sq"):
            if k in st:
                moments[f"{names[id(p)]}:{k}"] = numpy(whole(st[k], shards, names[id(p)]))
    return dict(weights=weights, moments=moments, step=trainer.state.step)


def offload_run(trainer: Trainer, weights: str, batch) -> dict:
    """3 steps of a ``host_offload_params`` Trainer: their metrics; after
    each, whether every storage of the rank's state is empty with its bytes
    in a host buffer; a checkpoint saved while the state is on the host (and
    whether it went back after the save); then a resume from that checkpoint
    (offloaded too) and its next step."""
    off = trainer.state.offload
    metrics, empty = [], []
    for _ in range(3):
        m = trainer.step_fn(trainer.state, trainer.put_batch(batch))
        metrics.append({k: float(v) for k, v in m.items()})
        sts = off.storages()
        empty.append(bool(sts) and all(st.nbytes() == 0 for st in sts)
                     and {st._cdata for st, _ in off.parked} == set(off.host)
                     and all(off.host[st._cdata].numel() for st, _ in off.parked))
    path = trainer.ckpt.save(trainer.state, epoch=0)
    back = all(st.nbytes() == 0 for st in off.storages())
    resumed = Trainer(CFG, dataclasses.replace(trainer.cfg, training_mode="resume"),
                      model=load_model(weights), device="cpu", metrics=NoMetrics())
    step4 = {k: float(v) for k, v in
             resumed.step_fn(resumed.state, resumed.put_batch(batch)).items()}
    return dict(metrics=metrics, empty_between_steps=empty, ckpt=str(path),
                empty_after_save=back, resumed_on_host=bool(resumed.state.offload.parked),
                step4=step4, host_bytes=sum(b.numel() for b in off.host.values()))


def zero_cases(rank, world, weights, batch, run_dir, restore_dir):
    """ZeRO-3 (``full``), ZeRO-2 (``grad_op``) over fsdp=2 and data=2 (HSDP),
    3 steps each on the global batch; the checkpoint of the ZeRO-3 run
    (gathered, written by rank 0) and a 4th step; a single-device run dir
    restored at fsdp=2."""
    out = {}
    for name, mesh, strategy in (("full", MeshConfig(fsdp=2), "full"),
                                 ("grad_op", MeshConfig(fsdp=2), "grad_op"),
                                 ("data", MeshConfig(data=2, fsdp=1), "full")):
        trainer = Trainer(CFG, run_config(f"{run_dir}/{name}", mesh=mesh,
                                          fsdp_strategy=strategy),
                          model=load_model(weights), device="cpu", metrics=NoMetrics())
        sharded = [(p.to_local().numel(), p.numel()) for p in trainer.model.parameters()]
        metrics, grads = train(trainer, batch)
        res = dict(metrics=metrics, grads=grads if rank == 0 else None,
                   local_rows=int(trainer.put_batch(batch).input_ids.shape[0]),
                   sharded=sum(loc < whole for loc, whole in sharded), n_params=len(sharded),
                   is_main=trainer.is_main)
        if name != "data":
            path = trainer.ckpt.save(trainer.state, epoch=0)
            saved = state_numpy(trainer)      # a gather: every rank calls
            res["saved"] = saved if rank == 0 else None
            res["ckpt"] = str(path)
            res["step4"] = {k: float(v) for k, v in
                            trainer.step_fn(trainer.state, trainer.put_batch(batch)).items()}
        out[name] = res
    # the same fsdp=2 meshes with the state on the host between steps
    for strategy in ("full", "grad_op"):
        trainer = Trainer(CFG, run_config(f"{run_dir}/{strategy}_offload", mesh=MeshConfig(fsdp=2),
                                          fsdp_strategy=strategy, host_offload_params=True),
                          model=load_model(weights), device="cpu", metrics=NoMetrics())
        out[f"{strategy}_offload"] = offload_run(trainer, weights, batch)
    # a run dir written on one device, restored at fsdp=2
    trainer = Trainer(CFG, run_config(restore_dir, mesh=MeshConfig(fsdp=2),
                                      training_mode="resume"),
                      model=load_model(weights), device="cpu", metrics=NoMetrics())
    restored = state_numpy(trainer)
    out["restored"] = restored if rank == 0 else {"step": restored["step"]}
    out["restored_step4"] = {k: float(v) for k, v in
                             trainer.step_fn(trainer.state, trainer.put_batch(batch)).items()}
    return out


def seq_cases(rank, world, weights, batch, attn, run_dir):
    """The ring and the all-gather route on one attention call (outputs and
    gradients of this rank's rows, the K/V rows each saw), then 3 train
    steps at seq=2 by each route."""
    from aki_torch.ops import ring_attention
    from aki_torch.ops.masks import MMASpec
    from aki_torch.ops.ring_attention import SeqShard

    from aki_torch.ops import flash_mma

    # what the all-gather route hands the flash attention: the kernels on the
    # card take contiguous K/V only
    contiguous, real = [], flash_mma.flash_mma_attention

    def recording(q, k, v, *args, **kwargs):
        contiguous.append(all(x.is_contiguous() for x in (q, k, v)))
        return real(q, k, v, *args, **kwargs)

    flash_mma.flash_mma_attention = recording
    out = {}
    t = attn["q"].shape[1]
    spec = MMASpec(*(torch.as_tensor(attn[k]) for k in ("img_start", "txt_start", "txt_end")))
    kvv = torch.as_tensor(attn["kv_valid"])
    for impl in ("ring", "allgather"):
        shard = SeqShard.create(dist.group.WORLD, t, spec, kvv, impl=impl)
        rows = slice(shard.lo, shard.lo + shard.tl)
        q, k, v = (torch.tensor(attn[n][:, rows], requires_grad=True) for n in "qkv")
        o = shard.attend(q, k, v)
        (o * torch.as_tensor(attn["g"][:, rows])).sum().backward()
        out[impl] = dict(out=o.detach().numpy(), dq=q.grad.numpy(), dk=k.grad.numpy(),
                         dv=v.grad.numpy(), kv_rows=list(shard.seen_kv_rows),
                         live=shard.live)
    flash_mma.flash_mma_attention = real
    out["allgather_contiguous"] = contiguous
    for impl in ("ring", "allgather"):
        ring_attention.SP_IMPL = impl
        trainer = Trainer(CFG, run_config(f"{run_dir}/{impl}", mesh=MeshConfig(fsdp=1, seq=2)),
                          model=load_model(weights), device="cpu", metrics=NoMetrics())
        metrics, grads = train(trainer, batch)
        out[f"step_{impl}"] = dict(metrics=metrics, grads=grads if rank == 0 else None)
    ring_attention.SP_IMPL = "ring"
    return out


def tp_cases(rank, world, weights, prompt, requests, max_len, new, int8, moe):
    """Tensor-parallel prefill (logits, the cache's heads), the vision
    tokens, greedy generate with a bf16 and an int8 cache, and a served
    drain with the int8 cache, at tensor=2; W8A8 weights with the int8
    cache (``int8``: the float weights, config and prompt), with the
    attention routes each step took; the MoE model (``moe``)."""
    import dataclasses

    from aki_torch.infer import engine
    from aki_torch.infer.server import ServingEngine
    from aki_torch.models import aki as aki_mod
    from aki_torch.models.common import F32
    from aki_torch.models.configs import MoEConfig
    from aki_torch.parallel.mesh import Mesh

    mesh = Mesh(MeshConfig(fsdp=1, tensor=2), "cpu")
    model = load_model(weights)
    ids, images, valid = prompt
    state = engine.prefill(model, ids, images, valid, max_len, policy=F32, device="cpu",
                           tp_mesh=mesh)
    with torch.inference_mode():
        vision = aki_mod.encode_vision(model, torch.as_tensor(images), F32)
    tower, per = model.vision_encoder, model.vision_tokenizer
    state8 = engine.prefill(model, ids, images, valid, max_len, policy=F32, device="cpu",
                            kv_int8=True)
    out = dict(logits=state.last_logits.numpy(), cache_k=tuple(state.cache.k.shape),
               cache8_k=tuple(state8.cache.k.shape), cache8_ks=tuple(state8.cache.ks.shape),
               qkv_rows=model.lang_model.model.layers[0].self_attn["qkv_proj"].weight.shape[0],
               head_rows=model.lang_model.lm_head.weight.shape[0], vision=vision.numpy(),
               tower_q_rows=tower.encoder["layers"][0].self_attn["q_proj"].weight.shape[0],
               tower_split=tower.tp is not None,
               perceiver_q_rows=next(iter(per.layers[0])).to_q.weight.shape[0],
               perceiver_split=per.tp is not None)
    for kv_int8 in (False, True):
        toks, num = engine.generate(model, ids, images, valid, new, max_len, policy=F32,
                                    device="cpu", kv_int8=kv_int8, tp_mesh=mesh)
        out[f"generate_int8={kv_int8}"] = (toks.numpy(), num.numpy())
    eng = ServingEngine(model, num_slots=4, max_len=max_len, prompt_bucket=16, admit_batch=2,
                        decode_chunk=2, policy=F32, kv_int8=True, device="cpu", tp_mesh=mesh)
    reqs = [eng.submit(r_ids, img, max_new_tokens=m) for r_ids, img, m in requests]
    eng.run_until_drained()
    out["served"] = [r.result(timeout=60) for r in reqs]
    eng.close()

    # W8A8 with the int8 cache: the routes each attention call took
    from aki_torch.models import phi3, quant, siglip

    routes = []

    def recording(mod, name):
        real = getattr(mod, name)

        def call(*args, **kwargs):
            routes.append((mod.__name__.rsplit(".", 1)[1], name, args[0].shape[-2]))
            return real(*args, **kwargs)
        return call

    patched = ((phi3, "flash_mma_attention"), (phi3, "decoder_attention_bf16p"),
               (siglip, "flash_mma_attention"), (siglip, "encoder_attention_bf16p"))
    real = {(mod, name): getattr(mod, name) for mod, name in patched}
    for mod, name in patched:
        setattr(mod, name, recording(mod, name))
    cfg8 = int8["cfg"]
    model8 = AKIModel(cfg8, device="cpu")
    model8.load_state_dict(torch.load(int8["weights"]), strict=True)
    quant.quantize_params(model8, "w8a8", vision=True)
    quant.FUSED_ACT_QUANT = "on"
    ids8, images8, valid8 = int8["prompt"]
    toks, num = engine.generate(model8, ids8, images8, valid8, int8["new"], int8["max_len"],
                                policy=F32, use_flash=True, kv_int8=True, device="cpu",
                                tp_mesh=mesh)
    st8 = engine.prefill(model8, ids8, images8, valid8, int8["max_len"], policy=F32,
                         device="cpu", kv_int8=True)
    quant.FUSED_ACT_QUANT = "auto"
    for (mod, name), fn in real.items():
        setattr(mod, name, fn)
    out["w8a8"] = dict(tokens=toks.numpy(), num=num.numpy(), routes=routes,
                       cache_k=tuple(st8.cache.k.shape),
                       qkv_rows=model8.lang_model.model.layers[0].self_attn["qkv_proj"].q
                       .shape[0])
    # W4A8: the same route, int4 projections whole
    model4 = AKIModel(cfg8, device="cpu")
    model4.load_state_dict(torch.load(int8["weights"]), strict=True)
    quant.quantize_params(model4, "w4a8", vision=True)
    quant.FUSED_ACT_QUANT = "on"
    toks, num = engine.generate(model4, ids8, images8, valid8, int8["new"], int8["max_len"],
                                policy=F32, use_flash=True, kv_int8=True, device="cpu",
                                tp_mesh=mesh)
    quant.FUSED_ACT_QUANT = "auto"
    qkv = model4.lang_model.model.layers[0].self_attn["qkv_proj"]
    out["w4a8"] = dict(tokens=toks.numpy(), num=num.numpy(), qkv_bits=qkv.bits,
                       qkv_rows=qkv.q.shape[0], qkv_in=qkv.in_features)

    # the MoE decoder: experts cut along their inner dim
    cfg_moe = dataclasses.replace(CFG, phi3=dataclasses.replace(
        CFG.phi3, moe=MoEConfig(**moe["fields"])))
    model_moe = AKIModel(cfg_moe, device="cpu")
    model_moe.load_state_dict(torch.load(moe["weights"]), strict=True)
    st = engine.prefill(model_moe, ids, images, valid, max_len, policy=F32, device="cpu",
                        tp_mesh=mesh)
    toks, num = engine.generate(model_moe, ids, images, valid, new, max_len, policy=F32,
                                device="cpu")
    out["moe"] = dict(logits=st.last_logits.numpy(), tokens=toks.numpy(), num=num.numpy(),
                      w_gate=tuple(model_moe.lang_model.model.layers[0].mlp.w_gate.shape))
    return out


def cli_cases(rank, world, pretrain_cfg, sft_cfg, out):
    """The training CLIs as ``torchrun`` would start them (RANK and
    WORLD_SIZE set): pretrain at fsdp=2 under ZeRO-2, SFT at fsdp=2, and
    each at tensor=2; each rank's metrics (rank 1 writes none); what still
    raises."""
    import json
    from pathlib import Path

    from aki_torch.train import pretrain, sft

    res = {}
    for name, mod, path, key, extra in (
            ("pretrain", pretrain, pretrain_cfg, "training", ["training.fsdp_strategy=grad_op"]),
            ("sft", sft, sft_cfg, "training_config", [])):
        run_dir = Path(out) / f"{name}_fsdp2"
        mod.main(["--config", path, "--device", "cpu", "mesh.fsdp=2",
                  f"{key}.run_dir={run_dir}", *extra])
        log = run_dir / "metrics.jsonl"
        dist.barrier()
        res[name] = ([json.loads(line) for line in log.read_text().splitlines()]
                     if rank == 0 else None)
        dist.barrier()
        # the same run over the tensor axis
        run_dir = Path(out) / f"{name}_tp2"
        mod.main(["--config", path, "--device", "cpu", "mesh.fsdp=1", "mesh.tensor=2",
                  f"{key}.run_dir={run_dir}"])
        dist.barrier()
        res[f"{name}_tp2"] = ([json.loads(line) for line in
                               (run_dir / "metrics.jsonl").read_text().splitlines()]
                              if rank == 0 else None)
        dist.barrier()
    # SFT with the state on the host between steps, at fsdp=2
    run_dir = Path(out) / "sft_offload"
    sft.main(["--config", sft_cfg, "--device", "cpu", "mesh.fsdp=2",
              "training_config.host_offload_params=true", f"training_config.run_dir={run_dir}"])
    dist.barrier()
    res["offload"] = ([json.loads(line) for line in
                       (run_dir / "metrics.jsonl").read_text().splitlines()]
                      if rank == 0 else None)
    dist.barrier()
    return res


def expert_cases(rank, world, layer, x, g, moe_cfgs, weights, batch, run_dir):
    """Mesh (data=2, expert=2): one MoE layer on each rank's rows, at each
    capacity factor of ``moe_cfgs`` (its output, aux, places, kept choices,
    the dispatched buffer's shape and gradients); then the MoE model's Trainer at data=2 x expert=2,
    fsdp=2 x expert=2 (with a checkpoint) and data=4, 3 steps each."""
    import dataclasses

    from aki_torch.models.configs import MoEConfig
    from aki_torch.models.moe import MoEMLP, moe_mlp, route
    from aki_torch.parallel.expert import MoEParallel
    from aki_torch.parallel.mesh import Mesh

    out = {}
    mesh = Mesh(MeshConfig(data=2, fsdp=1, expert=2), "cpu")
    n_e, r_e = mesh.shape["expert"], mesh.coord("expert")
    par = MoEParallel(token_group=mesh.group("data", "fsdp", "seq"), n_batch=2, n_seq=1,
                      batch_index=mesh.index("data", "fsdp"), seq_index=0,
                      ep_group=mesh.group("expert"), ep_rank=r_e, ep_size=n_e)
    rows = x.shape[0] // 2
    mine = slice(par.batch_index * rows, (par.batch_index + 1) * rows)
    buffers = []                     # the dispatched buffers' shapes
    experts_rows = par.experts_rows
    par.experts_rows = lambda buf: (buffers.append(tuple(buf.shape)), experts_rows(buf))[1]
    for name, fields in moe_cfgs.items():
        mc = MoEConfig(**fields)
        moe = MoEMLP(x.shape[-1], mc, device="cpu", dtype=torch.float32)
        with torch.no_grad():
            moe.router.weight.copy_(torch.as_tensor(layer["router"]))
            for w in ("w_gate", "w_up", "w_down"):
                moe.get_parameter(w).data = torch.as_tensor(layer[w]).chunk(n_e)[r_e].clone()
        moe.par = par
        xl = torch.tensor(x[mine], requires_grad=True)
        o, aux = moe_mlp(moe, xl, mc)
        r = route(moe, xl.detach().reshape(-1, x.shape[-1]), mc, par, rows=rows)
        ((o * torch.as_tensor(g[mine])).sum() + 0.5 * aux / par.tokens).backward()
        out[name] = dict(out=o.detach().numpy(), aux=float(aux), pos=r.pos.numpy(),
                         keep=r.keep.numpy(), cap=r.cap, dx=xl.grad.numpy(),
                         router=moe.router.weight.grad.numpy(),
                         experts={w: moe.get_parameter(w).grad.numpy()
                                  for w in ("w_gate", "w_up", "w_down")},
                         batch_index=par.batch_index, expert_rank=r_e,
                         buffer=buffers[-1], tokens=xl.shape[0] * xl.shape[1])
    cfg = dataclasses.replace(CFG, phi3=dataclasses.replace(
        CFG.phi3, moe=MoEConfig(**moe_cfgs["fit"])))
    for name, mesh_cfg in (("dp2_ep2", MeshConfig(data=2, fsdp=1, expert=2)),
                           ("fsdp2_ep2", MeshConfig(fsdp=2, expert=2)),
                           ("dp4", MeshConfig(data=4, fsdp=1))):
        model = AKIModel(cfg, device="cpu")
        model.load_state_dict(torch.load(weights), strict=True)
        trainer = Trainer(cfg, run_config(f"{run_dir}/{name}", mesh=mesh_cfg,
                                          moe_aux_weight=0.5),
                          model=model, device="cpu", metrics=NoMetrics())
        metrics, grads = train(trainer, batch)
        res = dict(metrics=metrics)
        if name == "fsdp2_ep2":
            path = trainer.ckpt.save(trainer.state, epoch=0)
            saved = state_numpy(trainer)["weights"]
            res.update(ckpt=str(path), saved=saved if rank == 0 else None)
        out[f"train_{name}"] = res
    return out




def pipe_cases(rank, world, weights, moe_weights, moe_fields, batch, fwd, run_dir,
               restore_dir):
    """pipe=2: the dense model's Trainer with 2 microbatches, 3 steps (the
    first step's gradients of this stage's parameters), its checkpoint (the
    stage's weights and moments beside it) and a 4th step; a single-device
    run dir restored at pipe=2; the MoE decoder's pipelined forward (hidden
    states, aux, the input's gradient); a batch the microbatches do not
    divide."""
    import dataclasses

    from aki_torch.models.common import F32
    from aki_torch.models.configs import MoEConfig
    from aki_torch.ops.masks import MMASpec
    from aki_torch.parallel.mesh import Mesh
    from aki_torch.parallel.pipeline import shard_pipeline

    out = {}
    trainer = Trainer(CFG, run_config(f"{run_dir}/dense", mesh=MeshConfig(fsdp=1, pipe=2),
                                      pp_microbatches=2),
                      model=load_model(weights), device="cpu", metrics=NoMetrics())
    metrics, grads = train(trainer, batch)
    out["dense"] = dict(metrics=metrics, grads=grads,
                        layers=list(trainer.model.lang_model.model.pipe.layers))
    path = trainer.ckpt.save(trainer.state, epoch=0)
    out["dense"].update(ckpt=str(path), saved=state_numpy(trainer), step4={
        k: float(v) for k, v in trainer.step_fn(trainer.state, trainer.put_batch(batch)).items()})
    restored = Trainer(CFG, run_config(restore_dir, mesh=MeshConfig(fsdp=1, pipe=2),
                                       pp_microbatches=2, training_mode="resume"),
                       model=load_model(weights), device="cpu", metrics=NoMetrics())
    out["restored"] = state_numpy(restored)
    cfg = dataclasses.replace(CFG, phi3=dataclasses.replace(CFG.phi3,
                                                            moe=MoEConfig(**moe_fields)))
    model = AKIModel(cfg, device="cpu")
    model.load_state_dict(torch.load(moe_weights), strict=True)
    shard_pipeline(model, Mesh(MeshConfig(fsdp=1, pipe=2), "cpu"), 2)
    x = torch.tensor(fwd["x"], requires_grad=True)
    spec = MMASpec(*(torch.as_tensor(fwd[k]) for k in ("img_start", "txt_start", "txt_end")))
    hidden, _, aux = model.lang_model.model(
        x, torch.as_tensor(fwd["positions"]), spec=spec, kv_valid=torch.as_tensor(fwd["kv_valid"]),
        policy=F32, use_flash=False, with_aux=True)
    ((hidden * torch.as_tensor(fwd["g"])).sum() + aux).backward()
    out["moe"] = dict(hidden=hidden.detach().numpy(), aux=float(aux), dx=x.grad.numpy())
    try:
        model.lang_model.model(x[:3], torch.as_tensor(fwd["positions"])[:3], policy=F32,
                               use_flash=False)
        out["odd_batch"] = "ran"
    except ValueError as e:
        out["odd_batch"] = str(e)
    return out



def replicated_grads(trainer: Trainer) -> dict:
    """This rank's gradients of the weights the tensor ranks replicate (its
    shard of each under FSDP2)."""
    split = trainer.model.tensor_shards.names
    return {n: local_numpy(p.grad) for n, p in trainer.model.named_parameters()
            if p.grad is not None and n not in split}


def local_numpy(t: torch.Tensor) -> np.ndarray:
    from aki_torch.train.optim import local

    return local(t).detach().float().numpy().copy()


def tp_train_cases(rank, world, weights, batch, run_dir, restore_dir,
                   moe_weights=None, moe_fields=None):
    """Training over the ``tensor`` axis. On 2 ranks: tensor=2 (3 steps,
    the first step's whole and replicated gradients, a checkpoint and a 4th
    step), its run dir restored at fsdp=2 and a single-device run dir
    restored at tensor=2. On 4 ranks:
    fsdp=2 x tensor=2 (with a checkpoint), data=2 x tensor=2, tensor=2 x
    seq=2, a single-device run dir restored at
    fsdp=2 x tensor=2, and the MoE model at expert=2 x tensor=2."""
    import dataclasses
    from pathlib import Path

    from aki_torch.models.configs import MoEConfig

    def trainer(name, mesh, model=None, cfg=CFG, **kw):
        return Trainer(cfg, run_config(f"{run_dir}/{name}", mesh=MeshConfig(**mesh), **kw),
                       model=model or load_model(weights), device="cpu", metrics=NoMetrics())

    def run(name, mesh, save=False):
        t = trainer(name, mesh)
        metrics, grads = train(t, batch)
        res = dict(metrics=metrics, grads=grads if rank == 0 else None,
                   replicated=replicated_grads(t), tensor_rank=t.mesh.coord("tensor"),
                   split={n: d for n, (d, _) in t.model.tensor_shards.names.items()},
                   local_rows=int(t.put_batch(batch).input_ids.shape[0]))
        if save:
            res["ckpt"] = str(t.ckpt.save(t.state, epoch=0))
            saved = state_numpy(t)
            res["saved"] = saved if rank == 0 else None
            res["step4"] = {k: float(v) for k, v in
                            t.step_fn(t.state, t.put_batch(batch)).items()}
        return res

    def restored(name, mesh, path):
        t = Trainer(CFG, run_config(path, mesh=MeshConfig(**mesh), training_mode="resume"),
                    model=load_model(weights), device="cpu", metrics=NoMetrics())
        st = state_numpy(t)
        return st if rank == 0 else {"step": st["step"]}

    out = {}
    if world == 2:
        out["tp2"] = run("tp2", dict(fsdp=1, tensor=2), save=True)
        out["tp2_on_fsdp2"] = restored("r1", dict(fsdp=2), str(Path(out["tp2"]["ckpt"]).parent))
        out["single_on_tp2"] = restored("r2", dict(fsdp=1, tensor=2), restore_dir)
        return out
    out["fsdp2_tp2"] = run("fsdp2_tp2", dict(fsdp=2, tensor=2), save=True)
    out["fsdp2_tp2_offload"] = offload_run(
        trainer("fsdp2_tp2_offload", dict(fsdp=2, tensor=2), host_offload_params=True),
        weights, batch)
    out["dp2_tp2"] = run("dp2_tp2", dict(data=2, fsdp=1, tensor=2))
    out["tp2_seq2"] = run("tp2_seq2", dict(fsdp=1, tensor=2, seq=2))
    out["single_on_fsdp2_tp2"] = restored("r3", dict(fsdp=2, tensor=2), restore_dir)
    cfg = dataclasses.replace(CFG, phi3=dataclasses.replace(CFG.phi3,
                                                            moe=MoEConfig(**moe_fields)))
    model = AKIModel(cfg, device="cpu")
    model.load_state_dict(torch.load(moe_weights), strict=True)
    t = trainer("moe_ep2_tp2", dict(fsdp=1, expert=2, tensor=2), model=model, cfg=cfg,
                moe_aux_weight=0.5)
    metrics, grads = train(t, batch)
    out["moe_ep2_tp2"] = dict(metrics=metrics, grads=grads if rank == 0 else None,
                              expert_tensor={n for n in t.model.tensor_shards.names
                                             if n in t.model.expert_shards.names})
    return out

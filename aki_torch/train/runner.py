"""Training runner: model and optimizer build, epoch loop, resume
(counterpart of ``aki_tpu/train/runner.py``).

Without a process group the Trainer runs on one device, and a ``mesh``
that needs more raises. Under one (``torchrun``, after
:func:`aki_torch.parallel.mesh.init_distributed`) every rank builds the
same model from the seed, then the Trainer shards it over ``mesh`` with
FSDP2 (:mod:`aki_torch.parallel.fsdp`; ``fsdp_strategy`` ``"full"`` is
ZeRO-3, ``"grad_op"`` ZeRO-2), keeps each rank's ``(data, fsdp)`` rows of
the global batch the loader gives every rank, and splits the spliced
sequence over ``seq``. Metrics and checkpoint writes happen on rank 0;
every rank takes part in gathering a checkpoint and restores one.

``host_offload_params`` keeps the parameters and the AdamW state in pinned
host memory between steps, copied onto the device for the step and back
after it (JAX's semantics, ``aki_tpu/train/runner.py:158-175, 215-228``):
it frees device memory between steps, not within one.

The MoE decoder routes over the global tokens and, with ``expert`` > 1,
holds E/n experts a rank (:mod:`aki_torch.parallel.expert`).

With ``pipe`` > 1 each rank is a pipeline stage
(:mod:`aki_torch.parallel.pipeline`, ``pp_microbatches`` microbatches).

Not ported (they raise, naming ROADMAP Queue 1 item 10): ``tensor`` in
training and ``host_offload_params`` under a process group.
"""

from __future__ import annotations

import dataclasses
import time
from collections.abc import Iterable

import torch
import torch.distributed as dist

from ..models.aki import AKIModel
from ..models.common import BF16, F32, resolve_device
from ..models.configs import AKIConfig
from ..parallel.fsdp import check_strategy
from ..parallel.mesh import BATCH_AXES, Mesh, MeshConfig, batch_rows, resolve_axis_sizes
from .checkpoints import CheckpointManager
from .metrics import AverageMeter, MetricsLogger
from .optim import (cast_frozen_to, decay_everything, decay_except_embeddings,
                    is_frozen_path, make_optimizer)
from .schedules import make_schedule
from .step import Batch, StepParallel, TrainState, make_train_step

UNPORTED = "not ported (ROADMAP Queue 1 item 10)"


@dataclasses.dataclass
class RunnerConfig:
    run_dir: str = "runs/default"
    learning_rate: float = 1e-4
    min_lr: float = 1e-6
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    lr_schedule: str = "cosine"
    grad_clip: float = 1.0
    grad_accum: int = 1
    precision: str = "bf16"            # "bf16" (fp32 master, bf16 compute) | "fp32"
    remat: bool = True
    remat_policy: str = "full"         # aki_torch.models.common.REMAT_POLICIES
    checkpoint_steps: int = 1000
    keep_last_checkpoints: int | None = None
    seed: int = 42
    decay_policy: str = "all"          # "all" (AKI) | "except_embeddings"
    order: str = "image_first"         # MMA | DOT ablation ("text_first")
    training_mode: str = "scratch"     # scratch | resume | sft_resume | sft_scratch
    log_every: int = 10
    host_offload: bool = False         # the "full" remat policy (train/step.py)
    frozen_bf16: bool = False          # store the frozen tower in bf16
    moe_aux_weight: float = 0.01       # Switch aux-loss weight (MoE decoder)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    fsdp_strategy: str = "full"        # "full" (ZeRO-3) | "grad_op" (ZeRO-2)
    host_offload_params: bool = False  # params + AdamW state pinned on the host
                                       # between steps
    pp_microbatches: int | None = None  # pipeline microbatches (mesh.pipe > 1)


class _NoMetrics:
    """The metrics of a rank other than 0: nothing is written."""

    last = None

    def log(self, step, **scalars):
        pass

    def close(self):
        pass


def check_parallel(model_cfg: AKIConfig, run_cfg: RunnerConfig, sizes: dict) -> None:
    """Raise on what the sharded Trainer does not run."""
    if sizes["tensor"] > 1:
        raise NotImplementedError(f"training with mesh tensor={sizes['tensor']}: {UNPORTED}")
    if sizes["expert"] > 1 and model_cfg.phi3.moe is None:
        raise ValueError(f"mesh expert={sizes['expert']} needs the MoE decoder (phi3.moe)")
    if run_cfg.host_offload_params:
        raise NotImplementedError(f"host_offload_params under a process group: {UNPORTED}")


class Trainer:
    """Builds the model (random weights from a ``torch.Generator`` seeded
    with ``seed``, or ``model``), the optimizer and the step on ``device``
    (``"cuda"`` by default; raises without a card unless ``"cpu"``). Metrics
    go to ``metrics``, by default a :class:`MetricsLogger` on ``run_dir``
    (on rank 0). ``distributed``: shard over ``run_cfg.mesh`` (default:
    when a process group is initialised); False trains this rank alone."""

    def __init__(self, model_cfg: AKIConfig, run_cfg: RunnerConfig,
                 model: AKIModel | None = None, device="cuda",
                 metrics: MetricsLogger | None = None, distributed: bool | None = None):
        self.model_cfg = model_cfg
        self.cfg = run_cfg
        self.device = resolve_device(device)
        if run_cfg.precision not in ("bf16", "fp32"):
            raise ValueError(f"precision must be 'bf16' or 'fp32', got {run_cfg.precision!r}")
        check_strategy(run_cfg.fsdp_strategy)
        self.policy = BF16 if run_cfg.precision == "bf16" else F32
        self.mesh = None
        if dist.is_initialized() if distributed is None else distributed:
            self.mesh = Mesh(run_cfg.mesh, self.device.type)
            check_parallel(model_cfg, run_cfg, self.mesh.shape)
        else:
            resolve_axis_sizes(run_cfg.mesh, 1)   # a mesh of more devices raises
        self.is_main = self.mesh is None or dist.get_rank() == 0
        if model is None:
            gen = torch.Generator(device=self.device).manual_seed(run_cfg.seed)
            model = AKIModel(model_cfg, device=self.device, generator=gen)
        if run_cfg.frozen_bf16:
            cast_frozen_to(model)
        parallel = None
        if self.mesh is not None:
            from ..parallel.fsdp import shard_model

            for name, p in model.named_parameters():
                if is_frozen_path(name):
                    p.requires_grad_(False)
            mesh = self.mesh
            loss_group = mesh.group(*BATCH_AXES, "seq")
            if mesh.shape["pipe"] > 1:
                from ..parallel.pipeline import shard_pipeline

                shard_pipeline(model, mesh, run_cfg.pp_microbatches)
            elif model_cfg.phi3.moe is not None:
                from ..parallel.expert import shard_experts

                shard_experts(model, mesh)
            shard_model(model, mesh, run_cfg.fsdp_strategy, self.policy.compute_dtype)
            parallel = StepParallel(
                loss_group=loss_group, grad_scale=mesh.size(*BATCH_AXES),
                seq_group=mesh.group("seq") if mesh.shape["seq"] > 1 else None,
                loss_ranks=mesh.size(*BATCH_AXES, "seq"))
        norm_group = None if self.mesh is None else self.mesh.group("fsdp")
        self._schedule = make_schedule(run_cfg.lr_schedule, run_cfg.learning_rate,
                                       run_cfg.min_lr, run_cfg.warmup_steps,
                                       run_cfg.total_steps)
        decay = (decay_everything if run_cfg.decay_policy == "all"
                 else decay_except_embeddings)
        self.state = TrainState(model, make_optimizer(
            model, self._schedule, weight_decay=run_cfg.weight_decay,
            grad_clip=run_cfg.grad_clip, decay_predicate=decay, norm_group=norm_group))
        self._mark_blocks(model)
        self.ckpt = CheckpointManager(run_cfg.run_dir, keep_last=run_cfg.keep_last_checkpoints,
                                      is_main=self.is_main)
        self.epoch = 0

        # resume restores weights, optimizer and counters; sft_scratch loads
        # the weights and starts the counters and the optimizer afresh
        if run_cfg.training_mode in ("resume", "sft_resume"):
            self.state, self.epoch = self.ckpt.restore(self.state)
        elif run_cfg.training_mode == "sft_scratch":
            self.ckpt.restore(self.state)
            self.state = TrainState(model, make_optimizer(
                model, self._schedule, weight_decay=run_cfg.weight_decay,
                grad_clip=run_cfg.grad_clip, decay_predicate=decay, norm_group=norm_group))
            self._mark_blocks(model)
        if run_cfg.frozen_bf16:
            # a checkpoint with an fp32 tower restores into the bf16 storage
            cast_frozen_to(model)

        self.step_fn = make_train_step(
            model_cfg, policy=self.policy, remat=run_cfg.remat, grad_accum=run_cfg.grad_accum,
            order=run_cfg.order, remat_policy=run_cfg.remat_policy, device=self.device,
            host_offload=run_cfg.host_offload, moe_aux_weight=run_cfg.moe_aux_weight,
            parallel=parallel)
        self.offload_ms: list[tuple[float, float]] = []   # (H2D, D2H) per step
        if run_cfg.host_offload_params:
            inner = self.step_fn

            def offloaded_step(state, batch):
                h2d = self._move_state(self.device)
                m = inner(state, batch)
                # the gradients are the step's temporaries, as in JAX: drop
                # them, so that nothing of the state stays on the device
                state.optimizer.zero_grad()
                self.offload_ms.append((h2d, self._move_state(torch.device("cpu"))))
                return m

            self.step_fn = offloaded_step
            self._move_state(torch.device("cpu"))
        if metrics is None:
            metrics = MetricsLogger(run_cfg.run_dir) if self.is_main else _NoMetrics()
        self.metrics = metrics

    def _mark_blocks(self, model) -> None:
        """Tell the clip which gradients are blocks of a whole held over
        more ranks than their shards: the expert weights under ``expert``, a
        pipeline stage's decoder layers under ``pipe``."""
        opt = self.state.optimizer
        shards = getattr(model, "expert_shards", None)
        pipe = model.lang_model.model.pipe
        if shards is not None:
            opt.blocks = {id(p) for n, p in model.named_parameters() if n in shards.names}
            opt.block_group = shards.group
        elif pipe is not None:
            opt.blocks = {id(p) for p in model.lang_model.model.layers.parameters()}
            opt.block_group = pipe.group

    def _move_state(self, target: torch.device) -> float:
        """Move every parameter, buffer and AdamW state tensor to ``target``:
        the host (pinned when the device is a card; a fresh copy on the CPU,
        where host and device are one place) or the device. Returns the ms
        the copies took on the card (CUDA events; 0.0 on the CPU)."""
        cuda = self.device.type == "cuda"
        to_host = target.type == "cpu"

        def move(t: torch.Tensor) -> torch.Tensor:
            if to_host:
                out = torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=cuda)
                out.copy_(t, non_blocking=cuda)
                return out
            return t.to(target, non_blocking=True)

        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
        with torch.no_grad():
            for t in (*self.model.parameters(), *self.model.buffers()):
                t.data = move(t.data)
            for st in self.state.optimizer.opt.state.values():
                for k, v in st.items():
                    if isinstance(v, torch.Tensor):
                        st[k] = move(v)
        if not cuda:
            return 0.0
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    @property
    def model(self) -> AKIModel:
        return self.state.model

    def put_batch(self, batch):
        """Loader batch(es) -> a :class:`Batch` of tensors on the device."""
        if isinstance(batch, tuple):
            return tuple(self.put_batch(b) for b in batch)
        batch = batch_rows(batch, self.mesh, stacked=self.cfg.grad_accum > 1)
        to = lambda x: torch.as_tensor(x).to(self.device, non_blocking=True)  # noqa: E731
        lw = getattr(batch, "loss_weight", None)
        return Batch(to(batch.input_ids), to(batch.images), to(batch.attn_valid),
                     to(batch.labels), None if lw is None or lw == 1.0 else float(lw))

    @staticmethod
    def _stack_micro(group):
        """``grad_accum`` consecutive loader batches as one :class:`Batch`
        with a leading micro-batch axis; tuples (several datasets) stack per
        element. Every batch of a group carries the same ``loss_weight``."""
        if isinstance(group[0], tuple):
            return tuple(Trainer._stack_micro([g[i] for g in group])
                         for i in range(len(group[0])))
        weights = {getattr(b, "loss_weight", None) for b in group}
        assert len(weights) == 1, f"one loss_weight per accumulation group, got {weights}"
        stack = lambda xs: torch.stack([torch.as_tensor(x) for x in xs])  # noqa: E731
        return Batch(stack([b.input_ids for b in group]), stack([b.images for b in group]),
                     stack([b.attn_valid for b in group]), stack([b.labels for b in group]),
                     weights.pop())

    def run_epoch(self, batch_iter: Iterable, epoch: int) -> int:
        """Run one epoch; returns the global step. Stops at ``total_steps``.

        With ``grad_accum > 1`` each optimizer step consumes that many
        consecutive loader batches; a trailing partial group is dropped, as
        in the JAX runner."""
        cfg = self.cfg
        if cfg.grad_accum > 1:
            def grouped(it=batch_iter, n=cfg.grad_accum):
                buf = []
                for b in it:
                    buf.append(b)
                    if len(buf) == n:
                        yield self._stack_micro(buf)
                        buf = []
            batch_iter = grouped()
        step_time, data_time = AverageMeter(), AverageMeter()
        t_end = time.perf_counter()
        for loader_batch in batch_iter:
            if self.state.step >= cfg.total_steps:
                break
            data_time.update(time.perf_counter() - t_end)
            m = self.step_fn(self.state, self.put_batch(loader_batch))
            step = self.state.step
            if step % cfg.log_every == 0:
                # host sync only at log boundaries
                self.metrics.log(step, training_loss=float(m["loss"]),
                                 learning_rate=self._schedule(step),
                                 grad_norm=float(m["grad_norm"]),
                                 step_time=step_time.avg, data_time=data_time.avg)
            if step % cfg.checkpoint_steps == 0:
                self.ckpt.save(self.state, epoch=epoch, step=step)
            step_time.update(time.perf_counter() - t_end)
            t_end = time.perf_counter()
        return self.state.step

    def finish(self, epoch: int):
        self.ckpt.save(self.state, epoch=epoch, step=self.state.step)
        self.metrics.close()

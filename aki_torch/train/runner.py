"""Training runner: model and optimizer build, epoch loop, resume
(counterpart of ``aki_tpu/train/runner.py``, single device).

``RunnerConfig`` has the JAX runner's single-device fields only; the mesh,
ZeRO-2, parameter host offload, pipeline and MoE fields are not ported, so a
config that needs them cannot be built (the CLIs refuse such YAML).
"""

from __future__ import annotations

import dataclasses
import time
from collections.abc import Iterable

import torch

from ..models.aki import AKIModel
from ..models.common import BF16, F32, resolve_device
from ..models.configs import AKIConfig
from .checkpoints import CheckpointManager
from .metrics import AverageMeter, MetricsLogger
from .optim import cast_frozen_to, decay_everything, decay_except_embeddings, make_optimizer
from .schedules import make_schedule
from .step import Batch, TrainState, make_train_step


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


class Trainer:
    """Builds the model (random weights from a ``torch.Generator`` seeded
    with ``seed``, or ``model``), the optimizer and the step on ``device``
    (``"cuda"`` by default; raises without a card unless ``"cpu"``). Metrics
    go to ``metrics``, by default a :class:`MetricsLogger` on ``run_dir``."""

    def __init__(self, model_cfg: AKIConfig, run_cfg: RunnerConfig,
                 model: AKIModel | None = None, device="cuda",
                 metrics: MetricsLogger | None = None):
        self.model_cfg = model_cfg
        self.cfg = run_cfg
        self.device = resolve_device(device)
        if run_cfg.precision not in ("bf16", "fp32"):
            raise ValueError(f"precision must be 'bf16' or 'fp32', got {run_cfg.precision!r}")
        self.policy = BF16 if run_cfg.precision == "bf16" else F32
        if model is None:
            gen = torch.Generator(device=self.device).manual_seed(run_cfg.seed)
            model = AKIModel(model_cfg, device=self.device, generator=gen)
        if run_cfg.frozen_bf16:
            cast_frozen_to(model)
        self._schedule = make_schedule(run_cfg.lr_schedule, run_cfg.learning_rate,
                                       run_cfg.min_lr, run_cfg.warmup_steps,
                                       run_cfg.total_steps)
        decay = (decay_everything if run_cfg.decay_policy == "all"
                 else decay_except_embeddings)
        self.state = TrainState(model, make_optimizer(
            model, self._schedule, weight_decay=run_cfg.weight_decay,
            grad_clip=run_cfg.grad_clip, decay_predicate=decay))
        self.ckpt = CheckpointManager(run_cfg.run_dir, keep_last=run_cfg.keep_last_checkpoints)
        self.epoch = 0

        # resume restores weights, optimizer and counters; sft_scratch loads
        # the weights and starts the counters and the optimizer afresh
        if run_cfg.training_mode in ("resume", "sft_resume"):
            self.state, self.epoch = self.ckpt.restore(self.state)
        elif run_cfg.training_mode == "sft_scratch":
            self.ckpt.restore(self.state)
            self.state = TrainState(model, make_optimizer(
                model, self._schedule, weight_decay=run_cfg.weight_decay,
                grad_clip=run_cfg.grad_clip, decay_predicate=decay))
        if run_cfg.frozen_bf16:
            # a checkpoint with an fp32 tower restores into the bf16 storage
            cast_frozen_to(model)

        self.step_fn = make_train_step(
            model_cfg, policy=self.policy, remat=run_cfg.remat, grad_accum=run_cfg.grad_accum,
            order=run_cfg.order, remat_policy=run_cfg.remat_policy, device=self.device,
            host_offload=run_cfg.host_offload)
        self.metrics = metrics if metrics is not None else MetricsLogger(run_cfg.run_dir)

    @property
    def model(self) -> AKIModel:
        return self.state.model

    def put_batch(self, batch):
        """Loader batch(es) -> a :class:`Batch` of tensors on the device."""
        if isinstance(batch, tuple):
            return tuple(self.put_batch(b) for b in batch)
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

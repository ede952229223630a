"""The train step: loss, gradients, accumulation, update (counterpart of
``aki_tpu/train/step.py``, single device).

- forward/backward under the bf16 compute policy with fp32 master
  parameters, each decoder layer and Perceiver block recomputed in the
  backward under ``remat`` (keeping what ``remat_policy`` keeps);
  ``host_offload`` (the JAX step's region that moves the ``dots`` products
  to pinned host memory) is the ``full`` policy here: the regions are the
  layers, whose inputs stay on the device, so host copies of the products
  would free nothing that ``full`` keeps, and they cost time;
- gradient accumulation is a Python loop over the micro-batches, each loss
  divided by the factor, so ``.grad`` holds the mean; frozen parameters have
  ``requires_grad=False`` and never get a ``.grad``;
- a tuple of batches is one step over several datasets: their (weighted)
  gradients sum, the logged loss is their mean;
- the loss is multiplied by ``loss_weight`` (per dataset: the CE loss only)
  and by ``loss_scale`` (the gradients keep that scale, as in the JAX step;
  the logged loss does not); a MoE decoder's Switch aux loss is added after
  the weight, times ``moe_aux_weight``;
- the metrics are ``loss`` and ``grad_norm``, the norm taken before the clip;
- spans (:mod:`aki_torch.trace`): ``train.step`` around a step, holding
  ``train.forward`` and ``train.backward`` for each dataset and
  micro-batch and ``train.optimizer`` around the clip and AdamW.

The port updates the model and the optimizer in place instead of returning
a new state.

Sharded (:class:`StepParallel`): the loss each rank backpropagates is its
share of the global mean (the count of valid labels summed over the batch
and sequence ranks) times the number of batch ranks, whose gradients FSDP2
averages; gradients are summed over the sequence ranks; the clip's norm
is taken over the shards; the logged loss is the shares' sum.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch
import torch.distributed as dist

from .. import trace
from ..models.aki import AKIModel, aki_forward
from ..models.common import BF16, Policy
from ..models.configs import AKIConfig
from .optim import AdamWClip, local


@dataclasses.dataclass
class StepParallel:
    """What a sharded step reduces over: ``loss_group`` (the batch and
    sequence ranks, ``loss_ranks`` of them), ``grad_scale`` (the number of
    batch ranks, over which FSDP2 averages) and ``seq_group`` (the sequence
    ranks, None without ``seq``)."""

    loss_group: object
    grad_scale: int = 1
    seq_group: object = None
    loss_ranks: int = 1         # ranks in loss_group: the MoE aux's share is 1/loss_ranks


@dataclasses.dataclass
class TrainState:
    model: AKIModel
    optimizer: AdamWClip
    step: int = 0
    offload: object = None      # a parallel.offload.HostOffload (host_offload_params)


@dataclasses.dataclass
class Batch:
    """One (micro)batch, or ``grad_accum`` micro-batches stacked on a leading
    axis. Arrays are numpy or tensors; ``loss_weight`` is a scalar (one per
    dataset) or None for 1."""

    input_ids: object     # (..., B, T)
    images: object        # (..., B, H, W, C)
    attn_valid: object    # (..., B, T)
    labels: object        # (..., B, T)
    loss_weight: float | None = None

    def micro(self, i: int) -> "Batch":
        return Batch(self.input_ids[i], self.images[i], self.attn_valid[i],
                     self.labels[i], self.loss_weight)


def make_loss_fn(cfg: AKIConfig, policy: Policy, remat: bool, use_flash: bool,
                 order: str = "image_first", remat_policy: str = "full",
                 device="cuda", host_offload: bool = False, moe_aux_weight: float = 0.01,
                 parallel: StepParallel | None = None
                 ) -> Callable[[AKIModel, Batch], torch.Tensor]:
    if host_offload:
        remat, remat_policy = True, "full"

    def loss_fn(model: AKIModel, batch: Batch) -> torch.Tensor:
        out = aki_forward(model, batch.input_ids, batch.images, batch.attn_valid,
                          labels=batch.labels, policy=policy, use_flash=use_flash,
                          order=order, device=device, remat=remat,
                          remat_policy=remat_policy,
                          loss_group=None if parallel is None else parallel.loss_group,
                          seq_group=None if parallel is None else parallel.seq_group)
        loss = out.loss
        if batch.loss_weight is not None:
            # the per-dataset multiplier scales the CE loss only: the
            # router's balance pressure does not vary by dataset
            loss = loss * batch.loss_weight
        if out.aux is not None:
            # under a split token set every rank holds the same global aux:
            # its share of the summed loss is 1/loss_ranks
            aux = out.aux if parallel is None else out.aux / parallel.loss_ranks
            loss = loss + moe_aux_weight * aux
        return loss
    return loss_fn


def make_train_step(
    cfg: AKIConfig,
    policy: Policy = BF16,
    remat: bool = True,
    use_flash: bool = True,
    grad_accum: int = 1,
    order: str = "image_first",
    loss_scale: float = 1.0,
    remat_policy: str = "full",
    device="cuda",
    host_offload: bool = False,
    moe_aux_weight: float = 0.01,
    parallel: StepParallel | None = None,
) -> Callable[[TrainState, Batch | tuple[Batch, ...]], dict]:
    """Build ``train_step(state, batch) -> {"loss", "grad_norm"}`` (0-d
    tensors on the device; nothing syncs with the host). ``batch`` holds
    ``grad_accum`` stacked micro-batches when ``grad_accum > 1``; a tuple of
    such batches is one step over several datasets."""
    loss_fn = make_loss_fn(cfg, policy, remat, use_flash, order, remat_policy, device,
                           host_offload, moe_aux_weight, parallel)
    grad_scale = 1 if parallel is None else parallel.grad_scale

    def accumulate(model, batch: Batch) -> torch.Tensor:
        """Backward of one dataset's (mean over micro-batches) loss into
        ``.grad``; returns that loss, detached."""
        micros = [batch] if grad_accum == 1 else [batch.micro(i) for i in range(grad_accum)]
        total = None
        for micro in micros:
            with trace.span("train.forward"):
                loss = loss_fn(model, micro) * loss_scale / grad_accum
            with trace.span("train.backward"):
                (loss * grad_scale if grad_scale != 1 else loss).backward()
            total = loss.detach() if total is None else total + loss.detach()
        return total

    def train_step(state: TrainState, batch) -> dict:
        with trace.span("train.step"):
            state.optimizer.zero_grad()
            batches = batch if isinstance(batch, tuple) else (batch,)
            loss = sum(accumulate(state.model, b) for b in batches) / len(batches)
            if parallel is not None:
                sync_grads(state.optimizer.params, parallel.seq_group)
                dist.all_reduce(loss, group=parallel.loss_group)
            with trace.span("train.optimizer"):
                grad_norm = state.optimizer.step()
            state.step += 1
            return {"loss": loss / loss_scale, "grad_norm": grad_norm}

    return train_step


def sync_grads(params, group) -> None:
    """Sum the gradients over ``group`` (the sequence ranks: each holds the
    gradient of its rows' share of the loss)."""
    if group is None:
        return
    for p in params:
        if p.grad is not None:
            dist.all_reduce(local(p.grad), group=group)

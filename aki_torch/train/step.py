"""The train step: loss, gradients, accumulation, update (counterpart of
``aki_tpu/train/step.py``, single device).

- forward/backward under the bf16 compute policy with fp32 master
  parameters, each decoder layer and Perceiver block recomputed in the
  backward under ``remat``;
- gradient accumulation is a Python loop over the micro-batches, each loss
  divided by the factor, so ``.grad`` holds the mean; frozen parameters have
  ``requires_grad=False`` and never get a ``.grad``;
- a tuple of batches is one step over several datasets: their (weighted)
  gradients sum, the logged loss is their mean;
- the loss is multiplied by ``loss_weight`` (per dataset) and by
  ``loss_scale`` (the gradients keep that scale, as in the JAX step; the
  logged loss does not);
- the metrics are ``loss`` and ``grad_norm``, the norm taken before the clip.

The port updates the model and the optimizer in place instead of returning
a new state.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

from ..models.aki import AKIModel, aki_forward
from ..models.common import BF16, Policy
from ..models.configs import AKIConfig
from .optim import AdamWClip


@dataclasses.dataclass
class TrainState:
    model: AKIModel
    optimizer: AdamWClip
    step: int = 0


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
                 device="cuda") -> Callable[[AKIModel, Batch], torch.Tensor]:
    def loss_fn(model: AKIModel, batch: Batch) -> torch.Tensor:
        out = aki_forward(model, batch.input_ids, batch.images, batch.attn_valid,
                          labels=batch.labels, policy=policy, use_flash=use_flash,
                          order=order, device=device, remat=remat,
                          remat_policy=remat_policy)
        if batch.loss_weight is not None:
            return out.loss * batch.loss_weight
        return out.loss
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
) -> Callable[[TrainState, Batch | tuple[Batch, ...]], dict]:
    """Build ``train_step(state, batch) -> {"loss", "grad_norm"}`` (0-d
    tensors on the device; nothing syncs with the host). ``batch`` holds
    ``grad_accum`` stacked micro-batches when ``grad_accum > 1``; a tuple of
    such batches is one step over several datasets."""
    loss_fn = make_loss_fn(cfg, policy, remat, use_flash, order, remat_policy, device)

    def accumulate(model, batch: Batch) -> torch.Tensor:
        """Backward of one dataset's (mean over micro-batches) loss into
        ``.grad``; returns that loss, detached."""
        micros = [batch] if grad_accum == 1 else [batch.micro(i) for i in range(grad_accum)]
        total = None
        for micro in micros:
            loss = loss_fn(model, micro) * loss_scale / grad_accum
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
        return total

    def train_step(state: TrainState, batch) -> dict:
        state.optimizer.zero_grad()
        batches = batch if isinstance(batch, tuple) else (batch,)
        loss = sum(accumulate(state.model, b) for b in batches) / len(batches)
        grad_norm = state.optimizer.step()
        state.step += 1
        return {"loss": loss / loss_scale, "grad_norm": grad_norm}

    return train_step

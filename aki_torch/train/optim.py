"""Optimizer: AdamW behind a global-norm clip, with weight-decay groups and
a frozen vision tower (counterpart of ``aki_tpu/train/optim.py``).

- the clip follows ``optax.clip_by_global_norm``: g * (max / ||g||) when
  ||g|| >= max, g unchanged otherwise (``clip_grad_norm_`` would divide by
  ||g|| + 1e-6 instead);
- AdamW follows ``optax.adamw``: bias-corrected moments, decoupled decay
  ``lr * wd * param`` on the decay group only, and the learning rate of
  update n (counted from 0) is ``schedule(n)``;
- the frozen tower (``vision_encoder.*``) gets ``requires_grad=False`` and
  is left out of the optimizer, so it holds no state (the counterpart of
  ``optax.set_to_zero``).

On CUDA the update is ``torch.optim.AdamW(fused=True)``; elsewhere a
per-parameter loop (``foreach=False``). Neither allocates whole-model
temporaries.
"""

from __future__ import annotations

from collections.abc import Callable

import torch
from torch import nn

Schedule = Callable[[int], float]


def is_frozen_path(name: str) -> bool:
    """The frozen SigLIP tower, in the reference checkpoint's names."""
    return name.startswith("vision_encoder.")


def decay_everything(name: str) -> bool:
    """AKI policy: every trainable parameter decays."""
    return True


def decay_except_embeddings(name: str) -> bool:
    """Language-stream policy: the embedding tables do not decay."""
    return "embed" not in name


def cast_frozen_to(model: nn.Module, dtype: torch.dtype = torch.bfloat16,
                   frozen_predicate: Callable[[str], bool] = is_frozen_path) -> nn.Module:
    """Store the frozen parameters in ``dtype`` (in place). They hold no
    optimizer state and the forward casts them to the compute dtype anyway,
    so with ``dtype`` equal to it the compute is the same and half the
    frozen bytes are freed."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if frozen_predicate(name) and p.is_floating_point():
                p.data = p.data.to(dtype)
    return model


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum ||t||^2) over ``tensors``, in f32, without a host sync."""
    norms = [torch.linalg.vector_norm(t.float()) for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamWClip:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, ...))``
    over the trainable parameters of ``model``.

    :meth:`step` reads the gradients in ``.grad`` and returns their global
    norm before the clip."""

    def __init__(self, model: nn.Module, learning_rate: float | Schedule,
                 weight_decay: float = 0.1, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, grad_clip: float = 1.0,
                 decay_predicate: Callable[[str], bool] = decay_everything,
                 frozen_predicate: Callable[[str], bool] = is_frozen_path):
        self.schedule = learning_rate if callable(learning_rate) else (
            lambda _count, lr=float(learning_rate): lr)
        self.grad_clip = grad_clip
        decay, no_decay = [], []
        for name, p in model.named_parameters():
            if frozen_predicate(name):
                p.requires_grad_(False)
            elif decay_predicate(name):
                decay.append(p)
            else:
                no_decay.append(p)
        self.params = decay + no_decay
        device = self.params[0].device
        fused = {"fused": True} if device.type == "cuda" else {"foreach": False}
        self.opt = torch.optim.AdamW(
            [{"params": decay, "weight_decay": weight_decay},
             {"params": no_decay, "weight_decay": 0.0}],
            lr=self.schedule(0), betas=(b1, b2), eps=eps, **fused)
        self.count = 0          # updates applied so far

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = global_norm(grads)
        factor = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
        for g in grads:
            g.mul_(factor.to(g.dtype))
        lr = float(self.schedule(self.count))
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        return {"adamw": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def make_optimizer(model: nn.Module, learning_rate: float | Schedule,
                   weight_decay: float = 0.1, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8, grad_clip: float = 1.0,
                   decay_predicate: Callable[[str], bool] = decay_everything,
                   frozen_predicate: Callable[[str], bool] = is_frozen_path) -> AdamWClip:
    """AdamW over the trainable parameters; the frozen ones are switched
    off (``requires_grad=False``) and hold no state."""
    return AdamWClip(model, learning_rate, weight_decay, b1, b2, eps, grad_clip,
                     decay_predicate, frozen_predicate)

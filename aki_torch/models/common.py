"""Shared primitives (counterpart of ``aki_tpu/models/common.py``): the
mixed-precision policy, the two norms, and the device rule of the entry
points."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class Policy:
    """Parameters are kept in ``param_dtype`` and cast to ``compute_dtype``
    at the point of use. A model built directly in the compute dtype casts
    nothing."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype) if x.is_floating_point() else x


F32 = Policy(compute_dtype=torch.float32)
BF16 = Policy()


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default of every
    entry point) raises where there is no card: nothing falls back to the
    CPU unless the caller asks for ``"cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("aki_torch: no CUDA device; pass device='cpu' to "
                           "run on the CPU")
    return device


def layernorm(weight: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in f32 and cast back to ``x.dtype``."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def rmsnorm(weight: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm computed in f32 and cast back to ``x.dtype``."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)


def empty(module_cls, *args, device, dtype, **kw) -> nn.Module:
    """A parameter container built on ``device`` with its parameters left
    uninitialised; the owning model fills them from its generator."""
    return nn.utils.skip_init(module_cls, *args, device=device, dtype=dtype, **kw)


def linear(lin: nn.Linear, x: torch.Tensor, policy: Policy) -> torch.Tensor:
    bias = None if lin.bias is None else policy.cast(lin.bias)
    return F.linear(x, policy.cast(lin.weight), bias)


def init_normal(gen: torch.Generator, std: float, *tensors) -> None:
    """Fill ``tensors`` in place with N(0, std^2) draws from ``gen``."""
    with torch.no_grad():
        for t in tensors:
            t.normal_(0.0, std, generator=gen)


def init_const(value: float, *tensors) -> None:
    with torch.no_grad():
        for t in tensors:
            t.fill_(value)


def init_norm(*norms) -> None:
    """LayerNorm/RMSNorm at their identity: scale 1, bias 0."""
    for n in norms:
        init_const(1.0, n.weight)
        if getattr(n, "bias", None) is not None:
            init_const(0.0, n.bias)

"""Shared primitives (counterpart of ``aki_tpu/models/common.py``): the
mixed-precision policy, the two norms, the device rule of the entry points,
and the per-layer recompute policies (``aki_tpu/models/phi3.py
_remat_policy``)."""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint


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
    CPU unless the caller asks for ``"cpu"``. Under an initialised process
    group, ``"cuda"`` is this rank's card, ``cuda:{LOCAL_RANK}``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("aki_torch: no CUDA device; pass device='cpu' to "
                           "run on the CPU")
    if (device.type == "cuda" and device.index is None and dist.is_available()
            and dist.is_initialized()):
        # one process per card: this rank's card, not card 0
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                         torch.cuda.current_device())))
    return device


# Per-layer recompute policies, passed as an argument (the JAX package reads
# AKI_REMAT_POLICY; the CLIs here read it too). All give the same numbers:
# - "full": keep each layer's inputs only, recompute the whole layer;
# - "dots": also keep the output of every matrix product without batch dims
#   (aten.mm / aten.addmm: the projections; jax's
#   dots_with_no_batch_dims_saveable), recompute the rest: norms, rope,
#   activations and the attention (the flash forward is no product);
# - "dots_nowide": "dots" except products wider than WIDE_PRODUCT outputs
#   (at AKI-4B the MLP's gate and up projections, 8,192 each).
REMAT_POLICIES = ("full", "dots", "dots_nowide")
WIDE_PRODUCT = 4096
_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
# The dispatch mode of the recomputed region this thread runs, if any: it is
# entered around each product (:func:`linear`) only, so that the region's
# other ops run without a Python dispatch each
_REGION = threading.local()


def _keep(out: torch.Tensor) -> torch.Tensor:
    """A product's output as the region keeps it until the backward."""
    return out.detach()


class _KeepProducts(TorchDispatchMode):
    """Forward of a recomputed region, around each product: the output of
    its matrix product (mm / addmm) goes to ``store`` in call order when
    ``policy`` keeps it (None where it does not)."""

    def __init__(self, store: list, policy: str, parts: dict[int, int]):
        super().__init__()
        self.store, self.policy, self.parts = store, policy, parts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _PRODUCTS:
            width = out.shape[-1]
            wide = self.parts.get(width, width) > WIDE_PRODUCT
            keep = not (self.policy == "dots_nowide" and wide)
            self.store.append(_keep(out) if keep else None)
        return out


class _ReuseProducts(TorchDispatchMode):
    """Recompute of the region in the backward, around each product: a
    product kept by :class:`_KeepProducts` is taken from ``store`` instead
    of being run again (autograd records it as it did in the forward);
    every other op runs."""

    def __init__(self, store: list):
        super().__init__()
        self.store, self.next = store, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _PRODUCTS and self.next < len(self.store):
            kept, self.store[self.next] = self.store[self.next], None
            self.next += 1
            if kept is not None:
                return kept
        return func(*args, **(kwargs or {}))


def remat_call(remat: bool, policy: str, fn, *args, parts: dict[int, int] | None = None):
    """``fn(*args)``; with ``remat`` and autograd recording, under
    ``torch.utils.checkpoint`` (non-reentrant), so that the backward
    recomputes ``fn`` instead of keeping its activations, keeping what
    ``policy`` (one of :data:`REMAT_POLICIES`) keeps. ``parts`` maps the
    output width of a fused product to the width of the widest product it
    stands for (a layer's qkv and gate/up projections are one product
    each here, three and two in the JAX package), for ``dots_nowide``.

    The selective policies keep the products that :func:`linear` computes
    (in the regions, every product without batch dims: the projections)
    through a pair of dispatch modes of their own, entered around each such
    product, rather than ``create_selective_checkpoint_contexts``: its modes
    see every op of the region (a Python dispatch each: ~0.3 s of host time
    a full-width pretrain step on an H100 when measured with modes so
    placed)."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat policy {policy!r} is not one of {REMAT_POLICIES}")
    if not (remat and torch.is_grad_enabled()):
        return fn(*args)
    if policy == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    store: list = []
    return checkpoint(fn, *args, use_reentrant=False, context_fn=lambda: (
        _in_region(_KeepProducts(store, policy, parts or {})),
        _in_region(_ReuseProducts(store))))


@contextlib.contextmanager
def _in_region(mode: TorchDispatchMode):
    outer = getattr(_REGION, "mode", None)
    _REGION.mode = mode
    try:
        yield
    finally:
        _REGION.mode = outer


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


def product(fn, *args) -> torch.Tensor:
    """``fn(*args)``, a matrix product without batch dims; in a recomputed
    region of a selective policy, under the region's dispatch mode."""
    mode = getattr(_REGION, "mode", None)
    if mode is None:
        return fn(*args)
    with mode:
        return fn(*args)


def linear(lin: nn.Linear, x: torch.Tensor, policy: Policy) -> torch.Tensor:
    """``lin`` applied to ``x`` in the compute dtype, through :func:`product`."""
    bias = None if lin.bias is None else policy.cast(lin.bias)
    return product(F.linear, x, policy.cast(lin.weight), bias)


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

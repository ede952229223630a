"""The reference one precision step down, for the check's control of a
bfloat16 training configuration: float8 (e4m3, one scale a tensor) wherever
the bf16 program holds bf16 — the operands of every projection and of the
head, and every activation the layers keep (``store``), forward and
backward — the rest as the plain reference."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the whole tensor."""
    s = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s


class _Fp8Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return fp8(x) @ fp8(w).t()

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        g = fp8(gy)
        gx = g @ fp8(w)
        gw = g.reshape(-1, g.shape[-1]).t() @ fp8(x).reshape(-1, x.shape[-1])
        return gx, gw


class _Fp8Store(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return fp8(t)

    @staticmethod
    def backward(ctx, g):
        return fp8(g)


def fp8_store(t: torch.Tensor) -> torch.Tensor:
    """An activation kept in float8, its gradient too."""
    return _Fp8Store.apply(t)


def fp8_product(w: dict):
    """The ``product(h, name)`` of :func:`aki_plain.batch_loss` in float8."""
    return lambda h, name: _Fp8Product.apply(h, w[name])

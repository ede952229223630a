"""Int8 and int4 weights for serving: weight-only (w8, w4) and dynamic
W8A8 / W4A8 (counterpart of ``aki_tpu/models/quant.py``).

:func:`quantize_params` replaces the model's big projections, in place, by
:class:`QuantTensor` modules: an int8 or int4 weight in the ``nn.Linear``
layout ``(out, in)`` with one bf16 scale per output channel
(per-output-channel symmetric max-abs, the JAX ``(in, out)`` kernel's
per-column scale), and the float bias where the layer has one. An int4
weight is stored packed, two's-complement nibbles two to a byte along
``in`` (:func:`pack_int4`: byte ``j`` of a row holds columns ``2j`` in its
low and ``2j + 1`` in its high nibble), half the bytes of int8.

- **w8** / **w4**: :func:`mm` converts the weight (unpacked first, for
  int4) to the activation's dtype for the product and scales the output,
  ``x @ q^T * s``.
- **w8a8** / **w4a8** (``a8=True``): when the product has at least 64
  rows, :func:`mm` quantizes the activation per row and runs an int8 x
  int8 -> int32 product (``torch._int_mm``, on the unpacked int8 values
  of an int4 weight; the JAX package leaves this product to XLA),
  rescaled by ``s_row * s_col`` in f32. Fewer rows (decode) take the
  weight-only route.

Ahead of an a8 product, one of the fused "op + quantize" kernels of
:mod:`aki_torch.ops.fused_quant` may produce the int8 rows directly
(:class:`PreQuant`), at the four sites of :data:`FUSED_SITES`. The switch
per site (JAX's ``AKI_FUSED_ACT_QUANT`` / ``AKI_FUSED_SITES``, here module
constants that tests set): ``FUSED_ACT_QUANT`` "auto" turns on the sites of
``FUSED_SITES`` for CUDA tensors, all four by default, and keeps the
composed path (norm or activation, then :func:`quantize_acts`) for CPU
tensors, as JAX's "auto" does off the TPU; "on" takes every site on every
device (CPU tensors then run the kernels' plain versions); "off" none.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import fused_quant as fq
from .common import layernorm, linear, rmsnorm

FUSED_ACT_QUANT = "auto"                              # "auto" | "on" | "off"
FUSED_SITES = frozenset({"ln", "rms", "silu", "gelu"})
A8_MIN_ROWS = 64                                      # mm's a8 gate
MODES = ("w8", "w8a8", "w4", "w4a8")


class QuantTensor(nn.Module):
    """Int8 weight ``q`` (out, in) (``bits=8``), or int4 packed two to a
    byte as int8 (out, in / 2) (``bits=4``); per-output-channel scale ``s``
    (out,) bf16, and the layer's float ``bias`` (or None); ``a8`` switches
    :func:`mm` to the int8 x int8 product."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor, a8: bool = False,
                 bias: torch.Tensor | None = None, bits: int = 8):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)
        self.register_buffer("bias", bias)
        self.a8 = a8
        self.bits = bits

    @property
    def in_features(self) -> int:
        return self.q.shape[1] * (8 // self.bits)

    def int8(self) -> torch.Tensor:
        """The weight's values as int8 (out, in): unpacked for int4."""
        return unpack_int4(self.q) if self.bits == 4 else self.q

    def extra_repr(self) -> str:
        return f"out={self.q.shape[0]}, in={self.in_features}, bits={self.bits}, a8={self.a8}"


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7], (..., n) with n even -> (..., n / 2) int8:
    byte ``j`` holds value ``2j`` in its low nibble and ``2j + 1`` in its
    high one, two's complement."""
    return (q[..., 1::2] << 4) | (q[..., 0::2] & 0x0F)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`pack_int4`: arithmetic shifts of int8 sign-extend
    each nibble."""
    lo, hi = (p << 4) >> 4, p >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1], 2 * p.shape[-1])


@dataclasses.dataclass
class PreQuant:
    """Activation rows already quantized by a fused kernel, consumed by
    :func:`mm` directly: int8 ``q`` (..., d), f32 ``s`` (..., 1), and the
    dtype of the consuming product's output."""

    q: torch.Tensor
    s: torch.Tensor
    dtype: torch.dtype


def quantize_tensor(w: torch.Tensor, a8: bool = False, bits: int = 8,
                    bias: torch.Tensor | None = None) -> QuantTensor:
    """Per-output-channel symmetric int8 (``bits=8``) or int4 (``bits=4``)
    of an ``(out, in)`` weight: ``s = max|w_row| / maxq`` (maxq 127 or 7; 1
    for an all-zero row), ``q = clip(round(w / s), -maxq, maxq)`` (round
    half to even, by the f32 scale), ``s`` stored in bf16. Int4 is packed
    along ``in``, which must be even (``ValueError``)."""
    if bits not in (8, 4):
        raise ValueError(f"weights are quantized to 8 or 4 bits, not {bits}")
    if bits == 4 and w.shape[-1] % 2:
        raise ValueError(f"int4 packs two columns a byte: in={w.shape[-1]} is odd")
    maxq = 127.0 if bits == 8 else 7.0
    w32 = w.float()
    amax = w32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax == 0, 1.0, amax / maxq)
    q = torch.clamp(torch.round(w32 / scale), -maxq, maxq).to(torch.int8)
    q = (pack_int4(q) if bits == 4 else q).contiguous()
    return QuantTensor(q, scale[:, 0].to(torch.bfloat16), a8,
                       None if bias is None else bias.detach(), bits=bits)


def is_quantized(w) -> bool:
    return isinstance(w, QuantTensor)


def quantize_acts(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (token) symmetric int8 over the last dim: (q int8, s f32
    (..., 1))."""
    return fq.quantize_rows(x.float())


def _int8_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 (..., in) x int8 (out, in)^T -> int32 (..., out)."""
    lead = xq.shape[:-1]
    y = torch._int_mm(xq.reshape(-1, xq.shape[-1]), wq.t())
    return y.reshape(*lead, wq.shape[0])


def mm(x, w: QuantTensor) -> torch.Tensor:
    """``x @ w^T`` for a :class:`QuantTensor` (its bias is not added here);
    ``x`` may be a :class:`PreQuant`. The a8 route engages only for at
    least ``A8_MIN_ROWS`` rows."""
    if isinstance(x, PreQuant):
        if not w.a8:
            raise TypeError("PreQuant activations need an a8 QuantTensor")
        y = _int8_product(x.q, w.int8())
        return (y.float() * x.s * w.s.float()).to(x.dtype)
    rows = x.numel() // x.shape[-1]
    if w.a8 and rows >= A8_MIN_ROWS:
        xq, sx = quantize_acts(x)
        y = _int8_product(xq, w.int8())
        return (y.float() * sx * w.s.float()).to(x.dtype)
    y = F.linear(x, w.int8().to(x.dtype))
    return y * w.s.to(x.dtype)


def project(lin, x, policy) -> torch.Tensor:
    """A projection layer, plain (``nn.Linear``, cast by ``policy``) or
    quantized (:func:`mm` plus the float bias in the compute dtype)."""
    if is_quantized(lin):
        y = mm(x, lin)
        return y if lin.bias is None else y + policy.cast(lin.bias)
    return linear(lin, x, policy)


def _fused_enabled(site: str, x: torch.Tensor) -> bool:
    if FUSED_ACT_QUANT == "auto":
        return x.device.type == "cuda" and site in FUSED_SITES
    return FUSED_ACT_QUANT == "on"


def _fusable(site: str, x: torch.Tensor, w) -> bool:
    """Should a fused kernel feed the product with ``w``? :func:`mm`'s a8
    gate plus the kernels' 128-multiple width."""
    return (_fused_enabled(site, x) and is_quantized(w) and w.a8
            and x.numel() // x.shape[-1] >= A8_MIN_ROWS and x.shape[-1] % 128 == 0)


def norm_quant_acts(kind: str, weight, bias, x: torch.Tensor, eps: float, probe):
    """The pre-product norm (``kind`` "rms" or "ln"): fused norm + quantize
    when the consuming weight ``probe`` takes the a8 route, else the plain
    norm. Either result is a valid first argument of :func:`mm`."""
    if _fusable(kind, x, probe):
        if kind == "rms":
            q, s = fq.rmsnorm_quant(x, weight, eps)
        else:
            q, s = fq.layernorm_quant(x, weight, bias, eps)
        return PreQuant(q=q, s=s, dtype=x.dtype)
    return rmsnorm(weight, x, eps) if kind == "rms" else layernorm(weight, bias, x, eps)


def silu_mul_quant_acts(gate: torch.Tensor, up: torch.Tensor, probe):
    """silu(gate) * up, fused with the quantize ahead of ``probe`` when
    fusable."""
    if _fusable("silu", gate, probe):
        q, s = fq.silu_mul_quant(gate, up)
        return PreQuant(q=q, s=s, dtype=up.dtype)
    return F.silu(gate.float()).to(up.dtype) * up


def gelu_quant_acts(x: torch.Tensor, bias: torch.Tensor, probe):
    """tanh-gelu(x + bias), fused with the quantize ahead of ``probe`` when
    fusable."""
    if _fusable("gelu", x, probe):
        q, s = fq.gelu_quant(x, bias)
        return PreQuant(q=q, s=s, dtype=x.dtype)
    return F.gelu((x + bias).float(), approximate="tanh").to(x.dtype)


def _quantize_linear(parent: nn.ModuleDict, name: str, a8: bool, bits: int = 8) -> None:
    lin = parent[name]
    parent[name] = quantize_tensor(lin.weight, a8=a8, bits=bits, bias=lin.bias)


def _pad_rows(w: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.cat([w, w.new_zeros((rows - w.shape[0],) + w.shape[1:])])


@torch.no_grad()
def quantize_params(model: nn.Module, mode: str = "w8", fuse: bool = False,
                    vision: bool = True) -> nn.Module:
    """Quantize the big projections of an :class:`~aki_torch.models.aki.AKIModel`
    for serving, in place (the JAX function returns a new tree; replacing
    the modules keeps one copy of the weights), and return the model.

    - the decoder's ``qkv_proj``, ``o_proj``, ``gate_up_proj`` and
      ``down_proj`` of every layer, and the LM head (its bias and the extra
      head stay float). The port's decoder always holds the fused q|k|v and
      gate|up projections; per-output-channel scales make them the same
      int8 values and scales as JAX's split ``wq``, ``wk``, ``wv``
      (``fuse=False``) or its ``wqkv`` (``fuse=True``);
    - with ``vision``, the SigLIP tower's projections too (biases stay
      float); ``fuse`` then merges its q, k and v into one ``qkv_proj``.
      Under a8 an fc1 width that is not a multiple of 128 (SigLIP-so400m:
      4304) is padded with zero fc1 rows, zero bias entries and zero fc2
      columns to the next multiple (4352), so that the fused gelu + quantize
      kernel can run; gelu(0) = 0 against zero weights changes no number.

    The embeddings, the norms, the patch embedding and the Perceiver stay
    float. ``mode`` is one of :data:`MODES`: the weight bits (8 or 4) and
    whether the activations are quantized (a8). In the w4 modes the
    decoder's projections and the head are int4 and the tower stays int8
    (decode never runs it), as in JAX. A MoE decoder raises
    ``NotImplementedError``, as the JAX function fails on one.
    """
    if mode not in MODES:
        raise ValueError(f"quantize mode {mode!r} is not one of {MODES}")
    if model.cfg.phi3.moe is not None:
        # the JAX function indexes the dense MLP's w_gate, which a MoE tree
        # lacks: int8 serving has no MoE decoder in either package
        raise NotImplementedError("quantize_params: the MoE decoder (Phi3Config.moe) has "
                                  "no int8 serving path; only the dense MLP is quantized")
    a8 = mode.endswith("a8")
    bits = 4 if mode.startswith("w4") else 8
    lm = model.lang_model
    for layer in lm.model.layers:
        for name in ("qkv_proj", "o_proj"):
            _quantize_linear(layer.self_attn, name, a8, bits)
        for name in ("gate_up_proj", "down_proj"):
            _quantize_linear(layer.mlp, name, a8, bits)
    head = lm.lm_head
    head.quant = quantize_tensor(head.weight, a8=a8, bits=bits)
    del head.weight
    if vision:
        for layer in model.vision_encoder.encoder["layers"]:
            att, mlp = layer.self_attn, layer.mlp
            if fuse:
                parts = [att.pop(n) for n in ("q_proj", "k_proj", "v_proj")]
                att["qkv_proj"] = quantize_tensor(
                    torch.cat([p.weight for p in parts]), a8=a8,
                    bias=torch.cat([p.bias for p in parts]))
            else:
                for name in ("q_proj", "k_proj", "v_proj"):
                    _quantize_linear(att, name, a8)
            _quantize_linear(att, "out_proj", a8)
            fc1_w, fc1_b, fc2_w = mlp["fc1"].weight, mlp["fc1"].bias, mlp["fc2"].weight
            inter = fc1_w.shape[0]
            if a8 and inter % 128:
                width = (inter + 127) // 128 * 128
                fc1_w, fc1_b = _pad_rows(fc1_w, width), _pad_rows(fc1_b, width)
                fc2_w = _pad_rows(fc2_w.t(), width).t()
            mlp["fc1"] = quantize_tensor(fc1_w, a8=a8, bias=fc1_b)
            mlp["fc2"] = quantize_tensor(fc2_w, a8=a8, bias=mlp["fc2"].bias)
    return model

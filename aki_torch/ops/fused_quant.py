"""Fused "elementwise op + per-row int8 quantize" (counterpart of
``aki_tpu/ops/fused_quant.py``).

The W8A8 serving path (:mod:`aki_torch.models.quant`) quantizes each
activation row before an int8 matmul. These four functions do the op that
precedes the matmul and the quantize in one pass over the row:

- :func:`rmsnorm_quant`   — decoder pre-attention / pre-MLP (Phi-3);
- :func:`layernorm_quant` — vision tower pre-attention / pre-MLP (SigLIP);
- :func:`silu_mul_quant`  — decoder MLP, silu(gate) * up ahead of down_proj;
- :func:`gelu_quant`      — vision MLP, tanh-gelu(fc1 + bias) ahead of fc2.

Each returns ``(q int8 like x, s f32 (..., 1))``. All math is f32 end to
end; ``s = max|h| / 127`` (1 when the max is 0) and
``q = clip(round(h / s), -127, 127)`` with round-half-to-even. The row
width must be a multiple of 128 (``ValueError`` otherwise), as in JAX.

On CUDA tensors each function launches its entry point of the CUDA C++
kernel ``csrc/fused_quant.cu`` (which replaces the four TPU kernels; its
header says what bounds it) and counts the launch in its ``launches``
attribute; it raises on what the kernel does not take (rows other than
bf16, for one) and never falls back.
On CPU tensors it runs the plain version beside it (``*_reference``).

The kernel gives each row to a team of warps that walks rows team, team +
teams, ... of a persistent grid; :func:`row_plan` mirrors its launch plan
and :func:`kernel_plan` asks the built kernel for it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build

# the kernel holds a row in the registers of a team of warps, at most this
# many values a lane (gelu's tanhf needs the most registers)
MAX_WIDTH = 8192
LANE_VALUES = {"rms": 96, "ln": 96, "silu": 64, "gelu": 36}
_OPS = {"rms": 0, "ln": 1, "silu": 2, "gelu": 3}
_lib = None


def quantize_rows(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 over the last dim of f32 ``h`` (the TPU
    kernels' ``_quantize_rows``): (q int8, s f32 (..., 1))."""
    amax = h.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax == 0, 1.0, amax / 127.0)
    q = torch.clamp(torch.round(h / s), -127, 127).to(torch.int8)
    return q, s


def row_plan(op: str, rows: int, d: int, sms: int, per_sm: int) -> tuple[int, int, int]:
    """(warps per row, teams per block, blocks) of a launch of ``op`` on
    ``rows`` rows of width ``d`` on ``sms`` SMs where ``per_sm`` blocks fit
    an SM (``fused_quant.cu:plan_team``, ``plan_op``). A row goes to a team
    of one warp where a lane holds it in LANE_VALUES[op] values, else four,
    else eight; of eight for few rows (up to 8 an SM); never fewer than one
    chunk of 4 values a lane. Blocks are 4 warps (one team of 8), and team
    ``t`` takes rows t, t + teams, ... of teams = blocks x teams per block."""
    cap = LANE_VALUES[op]
    team = 1 if d // 32 <= cap else 4 if d // 128 <= cap else 8
    if rows <= 8 * sms:
        team = 8
    while team > 1 and d // 4 < 32 * team:
        team = 4 if team == 8 else 1
    tpb = 4 if team == 1 else 1
    return team, tpb, min(-(-rows // tpb), sms * per_sm)


def kernel_plan(op: str, rows: int, d: int) -> tuple[int, int, int, int, int]:
    """The plan the built kernel would launch ``op`` with on the current
    CUDA device: (warps per row, teams per block, blocks, blocks per SM,
    ring stages)."""
    lib = _kernel_lib()
    out = (ctypes.c_int * 5)()
    rc = lib.fused_quant_plan(_OPS[op], rows, d, out)
    if rc != 0:
        raise RuntimeError("fused_quant_plan failed: " + lib.fused_quant_error_string(rc).decode())
    return tuple(out)


def _check_width(x: torch.Tensor) -> None:
    if x.shape[-1] % 128:
        raise ValueError(f"fused quant kernels need 128-multiple cols; {x.shape[-1]}")


def rmsnorm_quant_reference(x, scale, eps: float = 1e-5):
    """Plain version of :func:`rmsnorm_quant`."""
    _check_width(x)
    x32 = x.float()
    h = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return quantize_rows(h * scale.float())


def layernorm_quant_reference(x, scale, bias, eps: float = 1e-6):
    """Plain version of :func:`layernorm_quant`."""
    _check_width(x)
    x32 = x.float()
    xc = x32 - x32.mean(dim=-1, keepdim=True)
    h = xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    return quantize_rows(h * scale.float() + bias.float())


def silu_mul_quant_reference(gate, up):
    """Plain version of :func:`silu_mul_quant`."""
    _check_width(gate)
    return quantize_rows(F.silu(gate.float()) * up.float())


def gelu_quant_reference(x, bias):
    """Plain version of :func:`gelu_quant`."""
    _check_width(x)
    return quantize_rows(F.gelu(x.float() + bias.float(), approximate="tanh"))


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("fused_quant")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_quant.argtypes = [i, p, p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
        lib.fused_quant.restype = i
        lib.fused_quant_plan.argtypes = [i, i, i, p]
        lib.fused_quant_plan.restype = i
        lib.fused_quant_error_string.argtypes = [i]
        lib.fused_quant_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` as (rows, d) with unit column stride: a view where one exists
    (the gate and up halves of one fused projection keep their row stride),
    else a contiguous copy."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.stride(-1) != 1 or (x2.shape[0] > 1 and x2.stride(0) < x2.shape[1]):
        x2 = x2.contiguous()
    return x2


def _launch(op: str, x, y=None, g=None, b=None, eps: float = 0.0):
    """One launch of the kernel's ``op`` entry on CUDA tensors: rows are the
    flattened leading dims of ``x`` (and ``y``, of x's shape), read with
    their row strides; ``g``, ``b`` are (d,) per-column vectors, passed to
    the kernel in f32."""
    _check_width(x)
    d = x.shape[-1]
    if d > MAX_WIDTH:
        raise ValueError(f"fused quant kernel: width {d} exceeds {MAX_WIDTH}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused quant kernel takes bf16 rows, got {x.dtype}")
    dev = x.device
    for name, t in (("y", y), ("g", g), ("b", b)):
        if t is not None and t.device != dev:
            raise ValueError(f"fused quant kernel: {name} on {t.device}, x on {dev}")
    if y is not None and (y.shape != x.shape or y.dtype != x.dtype):
        raise ValueError(f"fused quant kernel: up {tuple(y.shape)} {y.dtype} does not "
                         f"match gate {tuple(x.shape)} {x.dtype}")
    for t in (g, b):
        if t is not None and t.shape != (d,):
            raise ValueError(f"fused quant kernel: vector of shape {tuple(t.shape)}, want ({d},)")
    lead = x.shape[:-1]
    x2 = _rows(x)
    y2 = None if y is None else _rows(y)
    g32 = None if g is None else g.float().contiguous()
    b32 = None if b is None else b.float().contiguous()
    for t in (x2, y2, g32, b32):
        if t is not None and (t.data_ptr() % 16 or (t.dim() == 2 and t.stride(0) % 8)):
            raise ValueError("fused quant kernel: operands must be 16-byte aligned")
    rows = x2.shape[0]
    q = torch.empty((rows, d), dtype=torch.int8, device=dev)
    s = torch.empty((rows, 1), dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        rc = lib.fused_quant(_OPS[op], ptr(x2), ptr(y2), ptr(g32), ptr(b32), ptr(q), ptr(s),
                             rows, d, x2.stride(0), d if y2 is None else y2.stride(0), float(eps),
                             torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_quant ({op}) launch failed: "
                           + lib.fused_quant_error_string(rc).decode())
    return q.reshape(*lead, d), s.reshape(*lead, 1)


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type != "cpu":
        raise ValueError(f"fused quant: no kernel for device {x.device}")
    return False


def rmsnorm_quant(x, scale, eps: float = 1e-5):
    """RMSNorm then per-row int8 quantize, one pass: the function of
    ``quantize_acts(rmsnorm(x))`` with the normed value kept in f32.
    Returns (q int8 like x, s f32 (..., 1))."""
    if not _on_cuda(x):
        return rmsnorm_quant_reference(x, scale, eps)
    out = _launch("rms", x, g=scale, eps=eps)
    rmsnorm_quant.launches += 1
    return out


def layernorm_quant(x, scale, bias, eps: float = 1e-6):
    """LayerNorm then per-row int8 quantize, one pass."""
    if not _on_cuda(x):
        return layernorm_quant_reference(x, scale, bias, eps)
    out = _launch("ln", x, g=scale, b=bias, eps=eps)
    layernorm_quant.launches += 1
    return out


def silu_mul_quant(gate, up):
    """silu(gate) * up then per-row int8 quantize, one pass."""
    if not _on_cuda(gate):
        return silu_mul_quant_reference(gate, up)
    out = _launch("silu", gate, y=up)
    silu_mul_quant.launches += 1
    return out


def gelu_quant(x, bias):
    """tanh-gelu(x + bias) then per-row int8 quantize, one pass."""
    if not _on_cuda(x):
        return gelu_quant_reference(x, bias)
    out = _launch("gelu", x, b=bias)
    gelu_quant.launches += 1
    return out


FUSED_QUANT_FUNCTIONS = (rmsnorm_quant, layernorm_quant, silu_mul_quant, gelu_quant)
for _fn in FUSED_QUANT_FUNCTIONS:
    _fn.launches = 0

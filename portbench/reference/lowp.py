"""Products computed one precision below the configuration's, for the
control of ``correct``.

The control is the plain reference put in the program's place and
computed in the nearest precision below the one the configuration states:
for bfloat16 GEMMs, float8 (e4m3) ones; for float32 ones, TF32.  Each
operand is rounded (fp8: scaled by its own absolute maximum onto e4m3's
range, 448, rounded and scaled back; TF32: its mantissa rounded to 10
bits, as the tensor cores read it), the product accumulates in float32,
and in the backward the incoming gradient is rounded the same way before
its two products, so that every GEMM of the step, forward and backward,
reads rounded operands.  The rounding is done here, so the control reads
the same on any device.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under a per-tensor scale, back in float32."""
    xf = x.float()
    amax = xf.abs().amax().clamp_min(1e-30)
    scale = E4M3_MAX / amax
    return (xf * scale).to(torch.float8_e4m3fn).float() / scale


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its float32 mantissa rounded to TF32's 10 bits (half
    away from zero), back in float32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _rounded(round_fn: Callable) -> Tuple[Callable, Callable]:
    """``(value, grad)``: the value rounded forward (its gradient passed
    as it comes), and the gradient rounded backward (the value as it
    is)."""
    class Value(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return round_fn(x)

        @staticmethod
        def backward(ctx, g):
            return g

    class Grad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return round_fn(g)
    return Value.apply, Grad.apply


def plain_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def plain_conv(x: torch.Tensor, w: torch.Tensor, stride: int,
               pad: int) -> torch.Tensor:
    return F.conv2d(x, w, stride=stride, padding=pad)


def products(precision: str) -> Tuple[Callable, Callable]:
    """``(matmul, conv)`` in ``precision``: ``exact`` (float32, the
    reference), ``fp8`` or ``tf32`` (the controls)."""
    if precision == "exact":
        return plain_matmul, plain_conv
    value, grad = _rounded({"fp8": round_fp8, "tf32": round_tf32}[precision])

    def matmul(a, b):
        return grad(value(a) @ value(b))

    def conv(x, w, stride, pad):
        return grad(F.conv2d(value(x), value(w), stride=stride, padding=pad))
    return matmul, conv


def control_of(precision: str) -> str:
    """The control's products for a configuration computing in
    ``precision``."""
    return {"bfloat16": "fp8", "float32": "tf32"}[precision]


def exact_products() -> None:
    """Full float32 products on the card: TF32 off for GEMMs and
    convolutions (PyTorch may otherwise keep about three decimal
    digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

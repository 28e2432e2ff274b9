"""Fused residual add + RMSNorm over rows: ``s = x + resid`` in float32,
``res = s`` in x's type, ``y = s * rsqrt(mean(s^2) + eps) * scale`` from
the unrounded ``s``.  Returns ``(y, res)``.

On CUDA tensors it launches the hand-written kernel
``csrc/fused_addnorm.cu`` (the port of the JAX package's Pallas
``fused_add_rmsnorm_pallas``; the source says how it is laid out and what
bounds it).  On CPU tensors it runs ``fused_add_rmsnorm_ref``, the plain
version.

``FusedAddRMSNormFn`` is the call as a ``torch.autograd.Function``: its
forward is ``impl.fused_add_rmsnorm``, the kernel on the card; its
backward is written in plain PyTorch.  The JAX package has no backward
kernel for ``fused_add_rmsnorm_pallas`` (XLA differentiates its model),
so none is invented: the backward recomputes ``fused_add_rmsnorm_ref``
from the saved inputs under autograd and returns its gradients, the
derivative of the function the kernel computes.
"""
from __future__ import annotations

import ctypes

import torch

from ._dispatch import (DTYPE_CODE, call, device_kind, library,
                        positive_int, same_dtype)
from .ref import fused_add_rmsnorm_ref

__all__ = ["fused_add_rmsnorm", "fused_add_rmsnorm_ref",
           "FusedAddRMSNormFn"]

SOURCE = "fused_addnorm.cu"
_LAUNCH = "fused_addnorm_launch"
_ARGTYPES = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_float, ctypes.c_void_p)
# the kernel keeps a row's float32 sums in one block's shared memory
MAX_D = 232_448 // 4
EPS = 1e-6


def fused_add_rmsnorm(x: torch.Tensor, resid: torch.Tensor,
                      scale: torch.Tensor, block_rows: int = 256):
    """``(y, res)`` of ``x``, ``resid`` (rows, d) and ``scale`` (d,).

    ``block_rows`` was the Pallas kernel's row tile in VMEM.  Rows are
    independent, and the CUDA kernel runs one block a row, so every
    ``block_rows`` gives the same bits; it must be a positive int."""
    kind = device_kind("fused_add_rmsnorm",
                       {"x": x, "resid": resid, "scale": scale})
    dtype = same_dtype("fused_add_rmsnorm", {"x": x, "resid": resid})
    positive_int("fused_add_rmsnorm", block_rows=block_rows)
    if x.dim() != 2 or resid.shape != x.shape or \
            scale.shape != (x.shape[1],):
        raise ValueError(f"fused_add_rmsnorm: x {tuple(x.shape)}, resid "
                         f"{tuple(resid.shape)} and scale "
                         f"{tuple(scale.shape)} do not match")
    if kind == "cpu":
        return fused_add_rmsnorm_ref(x, resid, scale, EPS)
    rows, d = x.shape
    y, res = torch.empty_like(x), torch.empty_like(x)
    if x.numel() == 0:
        return y, res
    if d > MAX_D or rows >= 2 ** 31:
        raise ValueError(f"fused_add_rmsnorm: ({rows}, {d}) exceeds the "
                         f"kernel's {MAX_D} columns or 2**31 - 1 rows")
    scale32 = scale.float()
    lib = library(SOURCE, _LAUNCH, _ARGTYPES)
    call(lib, _LAUNCH, x.device, DTYPE_CODE[dtype], x.data_ptr(),
         resid.data_ptr(), scale32.data_ptr(), y.data_ptr(), res.data_ptr(),
         rows, d, EPS)
    fused_add_rmsnorm.launches += 1
    return y, res


fused_add_rmsnorm.launches = 0


class FusedAddRMSNormFn(torch.autograd.Function):
    """``impl.fused_add_rmsnorm(x, resid, scale)``, ``kernels.ops`` by
    default, returning ``(y, res)``; the backward differentiates the
    plain version recomputed from the saved ``x``, ``resid`` and
    ``scale`` (a backward in plain PyTorch beside a forward kernel)."""

    @staticmethod
    def forward(ctx, x, resid, scale, impl=None):
        if impl is None:
            from . import ops as impl
        ctx.save_for_backward(x, resid, scale)
        return impl.fused_add_rmsnorm(x, resid, scale)

    @staticmethod
    def backward(ctx, dy, dres):
        inputs = [t.detach().requires_grad_(need) for t, need
                  in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            y, res = fused_add_rmsnorm_ref(*inputs, EPS)
            grads = iter(torch.autograd.grad((y, res), wanted, (dy, dres)))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs) + (None,)

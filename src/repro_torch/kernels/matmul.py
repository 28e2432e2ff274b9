"""GEMM ``C[m,n] = A[m,k] @ B[k,n]`` with float32 accumulation; C takes
A's type.

On CUDA tensors it launches the hand-written kernel ``csrc/matmul.cu``
(the port of the JAX package's Pallas ``matmul_pallas``; the source says
how it is laid out and what bounds it) with one of the tiles it is
compiled for, ``core.gpu_model.MATMUL_TILES``.  On CPU tensors it runs
``matmul_ref``, the plain version.  A GEMM with a zero dimension returns
the empty matrix or, for ``k == 0``, zeros, without a launch.

``MatmulFn`` is the GEMM as a ``torch.autograd.Function``: its backward
is two more GEMMs through the same entry point, ``dA = dC @ B^T`` and
``dB = A^T @ dC``.  The JAX package has no backward kernel for
``matmul_pallas``, so none is invented; the wrapper takes only contiguous
operands, so each transpose is a contiguous copy.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.gpu_model import MATMUL_TILES
from ._dispatch import DTYPE_CODE, call, device_kind, library, same_dtype
from .ref import matmul_ref

__all__ = ["matmul", "matmul_ref", "check_tile", "MatmulFn"]

SOURCE = "matmul.cu"
_LAUNCH = "matmul_launch"
_ARGTYPES = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def check_tile(bm: int, bn: int, bk: int) -> None:
    """Raise ``ValueError`` unless ``(bm, bn, bk)`` is a compiled tile."""
    if (bm, bn, bk) not in MATMUL_TILES:
        raise ValueError(f"matmul: tile ({bm}, {bn}, {bk}) is not compiled; "
                         f"matmul.cu has {sorted(MATMUL_TILES)}")


def matmul(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int,
           bk: int) -> torch.Tensor:
    """``a @ b`` with tile ``(bm, bn, bk)``, which must be compiled.  A
    tile larger than the GEMM is masked at the edge, which gives what the
    Pallas kernel computes with its block clamped to the dimension."""
    kind = device_kind("matmul", {"a": a, "b": b})
    dtype = same_dtype("matmul", {"a": a, "b": b})
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not multiply")
    check_tile(bm, bn, bk)
    if kind == "cpu":
        return matmul_ref(a, b)
    (m, k), n = a.shape, b.shape[1]
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=dtype, device=a.device)
    out = torch.empty((m, n), dtype=dtype, device=a.device)
    lib = library(SOURCE, _LAUNCH, _ARGTYPES)
    call(lib, _LAUNCH, a.device, DTYPE_CODE[dtype], a.data_ptr(),
         b.data_ptr(), out.data_ptr(), m, n, k, bm, bn, bk)
    matmul.launches += 1
    return out


matmul.launches = 0


class MatmulFn(torch.autograd.Function):
    """``impl.matmul(a, b)``, ``kernels.ops`` by default (which picks the
    tile), whose backward is ``impl.matmul(dC, B^T)`` for ``a`` and
    ``impl.matmul(A^T, dC)`` for ``b``, each made only where that input
    needs a gradient."""

    @staticmethod
    def forward(ctx, a, b, impl=None):
        if impl is None:
            from . import ops as impl
        ctx.save_for_backward(a, b)
        ctx.impl = impl
        return impl.matmul(a, b)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        dc = dc.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = ctx.impl.matmul(dc, b.t().contiguous())
        if ctx.needs_input_grad[1]:
            db = ctx.impl.matmul(a.t().contiguous(), dc)
        return da, db, None

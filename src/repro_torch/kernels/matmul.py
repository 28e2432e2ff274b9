"""GEMM ``C[m,n] = A[m,k] @ B[k,n]`` with float32 accumulation; C takes
A's type.

On CUDA tensors it launches the hand-written kernel ``csrc/matmul.cu``
(the port of the JAX package's Pallas ``matmul_pallas``; the source says
how it is laid out and what bounds it) with one of the tiles it is
compiled for (``core.gpu_model.compiled_tiles``: ``MATMUL_TILES`` in
bf16, ``F32_TILES`` in float32), on the route
``core.gpu_model.matmul_route`` gives from the shape, type, pointers and
tile: ``wgmma`` (bf16, TMA and wgmma) or ``mma`` (WMMA for bf16; for f32
CUDA-core FMAs fed by a ring of shared-memory stages that TMA or
``cp.async`` fills).  With ``splits > 1`` the
kernel cuts K into that many ranges and writes float32 partials to a
workspace this wrapper allocates; a second kernel sums them in split
order.  On CPU tensors it runs ``matmul_ref``, the plain version.  A GEMM
with a zero dimension returns the empty matrix or, for ``k == 0``, zeros,
without a launch.

``matmul.launches`` counts the calls that launch; ``matmul.routes``
counts them by route, and those with a split-K reduction under
``"splitk"``; ``matmul.f32_loads`` counts the float32 launches by how the
kernel fills its ring (``core.gpu_model.f32_tma_ok``): ``"tma"``, or
``"cp.async"`` for an operand TMA cannot read (a row not a multiple of 4
floats, a base not 16-byte aligned).

``MatmulFn`` is the GEMM as a ``torch.autograd.Function``: its backward
is two more GEMMs through the same entry point, ``dA = dC @ B^T`` and
``dB = A^T @ dC``.  The JAX package has no backward kernel for
``matmul_pallas``, so none is invented; the wrapper takes only contiguous
operands, so each transpose is a contiguous copy.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.gpu_model import compiled_tiles, f32_tma_ok, matmul_route
from ._dispatch import DTYPE_CODE, call, device_kind, library, same_dtype
from .ref import matmul_ref

__all__ = ["matmul", "matmul_ref", "check_tile", "MatmulFn"]

SOURCE = "matmul.cu"
_LAUNCH = "matmul_launch"
_ARGTYPES = (ctypes.c_int, ctypes.c_int) + (ctypes.c_void_p,) * 4 + (
    ctypes.c_longlong,) * 3 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
# csrc/matmul.cu's route codes
ROUTE_CODE = {"mma": 0, "wgmma": 1}


def check_tile(bm: int, bn: int, bk: int, bytes_in: int = 2) -> None:
    """Raise ``ValueError`` unless ``(bm, bn, bk)`` is a tile compiled for
    elements of ``bytes_in`` bytes."""
    tiles = compiled_tiles(bytes_in)
    if (bm, bn, bk) not in tiles:
        raise ValueError(f"matmul: tile ({bm}, {bn}, {bk}) is not compiled; "
                         f"matmul.cu has {sorted(tiles)} for "
                         f"{bytes_in}-byte elements")


def matmul(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int,
           bk: int, splits: int = 1) -> torch.Tensor:
    """``a @ b`` with tile ``(bm, bn, bk)``, which must be compiled, in
    ``splits`` K ranges (1 to ``ceil(k / bk)``).  A tile larger than the
    GEMM is masked at the edge, which gives what the Pallas kernel
    computes with its block clamped to the dimension; the split changes
    only the order of the float32 sums."""
    kind = device_kind("matmul", {"a": a, "b": b})
    dtype = same_dtype("matmul", {"a": a, "b": b})
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not multiply")
    check_tile(bm, bn, bk, a.element_size())
    (m, k), n = a.shape, b.shape[1]
    if not isinstance(splits, int) or isinstance(splits, bool) or \
            splits < 1 or splits > max(1, -(-k // bk)):
        raise ValueError(f"matmul: splits must be an int in [1, "
                         f"ceil(k / bk)] = [1, {max(1, -(-k // bk))}], "
                         f"got {splits!r}")
    if kind == "cpu":
        return matmul_ref(a, b)
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=dtype, device=a.device)
    route = matmul_route(n, k, a.element_size(), (bm, bn, bk),
                         a.data_ptr(), b.data_ptr())
    out = torch.empty((m, n), dtype=dtype, device=a.device)
    ws = None if splits == 1 else torch.empty(
        (splits, m, n), dtype=torch.float32, device=a.device)
    lib = library(SOURCE, _LAUNCH, _ARGTYPES)
    call(lib, _LAUNCH, a.device, DTYPE_CODE[dtype], ROUTE_CODE[route],
         a.data_ptr(), b.data_ptr(), out.data_ptr(),
         None if ws is None else ws.data_ptr(), m, n, k, bm, bn, bk, splits)
    matmul.launches += 1
    matmul.routes[route] += 1
    if splits > 1:
        matmul.routes["splitk"] += 1
    if dtype == torch.float32:
        tma = f32_tma_ok(n, k, a.data_ptr(), b.data_ptr())
        matmul.f32_loads["tma" if tma else "cp.async"] += 1
    return out


matmul.launches = 0
matmul.routes = {"wgmma": 0, "mma": 0, "splitk": 0}
matmul.f32_loads = {"tma": 0, "cp.async": 0}


class MatmulFn(torch.autograd.Function):
    """``impl.matmul(a, b)``, ``kernels.ops`` by default (which picks the
    tile), whose backward is ``impl.matmul(dC, B^T)`` for ``a`` and
    ``impl.matmul(A^T, dC)`` for ``b``, each made only where that input
    needs a gradient.  ``kept``: the output a rematerialised layer
    group's forward kept for its recompute (``models/remat.py``),
    returned in place of a launch."""

    @staticmethod
    def forward(ctx, a, b, impl=None, kept=None):
        if impl is None:
            from . import ops as impl
        ctx.save_for_backward(a, b)
        ctx.impl = impl
        return impl.matmul(a, b) if kept is None else kept

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        dc = dc.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = ctx.impl.matmul(dc, b.t().contiguous())
        if ctx.needs_input_grad[1]:
            db = ctx.impl.matmul(a.t().contiguous(), dc)
        return da, db, None, None

"""Training batch norm over ``x`` (N_eff, C), the (h*w*n, c) rows of the
paper's Sec. V-C.

* ``bn_forward``: ``(y, mu, psi)`` with ``psi = rsqrt(var + eps)`` and
  ``y = (x - mu) * psi * gamma + beta``; ``mu`` and ``psi`` are float32,
  ``y`` takes x's type.
* ``bn_backward``: Algorithm 1 (Eqs. 25-28), ``(dx, dgamma, dbeta)`` from
  x, dy and the forward's ``mu``, ``psi``; ``dx`` takes x's type,
  ``dgamma`` and ``dbeta`` are float32.
* ``BatchNormFn``: the two as a ``torch.autograd.Function``.

On CUDA tensors they launch the hand-written kernels of
``csrc/bn_forward.cu`` and ``csrc/bn_backward.cu`` (the ports of the JAX
package's Pallas ``bn_forward_pallas`` and ``bn_backward_pallas``; the
sources say how they are laid out and what bounds them).  The forward
computes ``var = E[x^2] - mu^2`` as the Pallas kernel does; the backward
recomputes ``x^`` in float32 in its second part rather than storing it.
On CPU tensors they run ``bn_forward_ref`` (the oracle's two-pass
variance) and ``bn_backward_ref``, the plain versions.
"""
from __future__ import annotations

import ctypes

import torch

from ._dispatch import (DTYPE_CODE, call, device_kind, library,
                        positive_int, same_dtype)
from .ref import bn_backward_ref, bn_forward_ref

__all__ = ["bn_forward", "bn_backward", "BatchNormFn", "bn_forward_ref",
           "bn_backward_ref"]

SOURCE = "bn_forward.cu"
_LAUNCH = "bn_forward_launch"
_ARGTYPES = (ctypes.c_int,) + (ctypes.c_void_p,) * 8 + (
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_void_p)
BACKWARD_SOURCE = "bn_backward.cu"
_BACKWARD_LAUNCH = "bn_backward_launch"
_BACKWARD_ARGTYPES = (ctypes.c_int,) + (ctypes.c_void_p,) * 10 + (
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p)
MAX_BLOCK_C = 1024      # one thread a channel of the tile
EPS = 1e-5


def bn_forward(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               block_rows: int = 256, block_c: int = 128):
    """``(y, mu, psi)`` of ``x`` (N_eff, C) and ``gamma``, ``beta`` (C,).

    On the card, ``block_rows`` rows and ``block_c`` channels (each
    clamped to the tensor, as the Pallas kernel clamps its block) make one
    tile of the statistics pass: a block sums its tile, and the tiles'
    partial sums are added in a fixed order.  The tile changes only the
    order of the float32 sums.  ``block_c`` is at most 1024."""
    kind = device_kind("bn_forward", {"x": x, "gamma": gamma, "beta": beta})
    dtype = x.dtype
    same_dtype("bn_forward", {"gamma": gamma, "beta": beta})
    _check_tile("bn_forward", block_rows, block_c)
    if x.dim() != 2 or gamma.shape != (x.shape[1],) or \
            beta.shape != gamma.shape:
        raise ValueError(f"bn_forward: x {tuple(x.shape)}, gamma "
                         f"{tuple(gamma.shape)} and beta "
                         f"{tuple(beta.shape)} do not match")
    n, c = x.shape
    if n == 0 or c == 0:
        raise ValueError(f"bn_forward: nothing to normalise in {(n, c)}")
    if kind == "cpu":
        return bn_forward_ref(x, gamma, beta, EPS)
    br, bc = min(block_rows, n), min(block_c, c)
    chunks = -(-n // br)
    if chunks >= 2 ** 31:
        raise ValueError(f"bn_forward: {chunks} row tiles exceed the grid")
    dev = x.device
    y = torch.empty_like(x)
    mu = torch.empty(c, dtype=torch.float32, device=dev)
    psi = torch.empty(c, dtype=torch.float32, device=dev)
    psum = torch.empty((chunks, c), dtype=torch.float32, device=dev)
    psq = torch.empty((chunks, c), dtype=torch.float32, device=dev)
    g32, b32 = gamma.float(), beta.float()
    lib = library(SOURCE, _LAUNCH, _ARGTYPES)
    call(lib, _LAUNCH, dev, DTYPE_CODE[dtype], x.data_ptr(), g32.data_ptr(),
         b32.data_ptr(), y.data_ptr(), mu.data_ptr(), psi.data_ptr(),
         psum.data_ptr(), psq.data_ptr(), n, c, br, bc, EPS)
    bn_forward.launches += 1
    return y, mu, psi


bn_forward.launches = 0


def _check_tile(fn: str, block_rows: int, block_c: int) -> None:
    positive_int(fn, block_rows=block_rows, block_c=block_c)
    if block_c > MAX_BLOCK_C:
        raise ValueError(f"{fn}: block_c {block_c} exceeds {MAX_BLOCK_C} "
                         f"channels a block")


def bn_backward(x: torch.Tensor, dy: torch.Tensor, gamma: torch.Tensor,
                mu: torch.Tensor, psi: torch.Tensor, block_rows: int = 256,
                block_c: int = 128):
    """``(dx, dgamma, dbeta)`` of ``x``, ``dy`` (N_eff, C), one type, and
    ``gamma`` (C,) with the forward's float32 ``mu`` and ``psi`` (C,).

    On the card the tile is that of ``bn_forward``: ``block_rows`` x
    ``block_c`` (clamped to the tensor, ``block_c`` at most 1024) is one
    block of part 1's sums, and changes only the order of the float32
    sums of dgamma and dbeta."""
    kind = device_kind("bn_backward", {"x": x, "dy": dy, "gamma": gamma,
                                       "mu": mu, "psi": psi})
    dtype = same_dtype("bn_backward", {"x": x, "dy": dy})
    if mu.dtype != torch.float32 or psi.dtype != torch.float32:
        raise TypeError(f"bn_backward: mu and psi must be float32, got "
                        f"{mu.dtype} and {psi.dtype}")
    _check_tile("bn_backward", block_rows, block_c)
    if x.dim() != 2 or dy.shape != x.shape or \
            any(t.shape != (x.shape[1],) for t in (gamma, mu, psi)):
        raise ValueError(f"bn_backward: x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}, gamma {tuple(gamma.shape)}, "
                         f"mu {tuple(mu.shape)} and psi {tuple(psi.shape)} "
                         f"do not match")
    n, c = x.shape
    if n == 0 or c == 0:
        raise ValueError(f"bn_backward: nothing to differentiate in "
                         f"{(n, c)}")
    if kind == "cpu":
        return bn_backward_ref(x, dy, gamma, mu, psi)
    br, bc = min(block_rows, n), min(block_c, c)
    chunks = -(-n // br)
    if chunks >= 2 ** 31:
        raise ValueError(f"bn_backward: {chunks} row tiles exceed the grid")
    dev = x.device
    dx = torch.empty_like(x)
    dg = torch.empty(c, dtype=torch.float32, device=dev)
    db = torch.empty(c, dtype=torch.float32, device=dev)
    pdg = torch.empty((chunks, c), dtype=torch.float32, device=dev)
    pdb = torch.empty((chunks, c), dtype=torch.float32, device=dev)
    g32 = gamma.float()
    lib = library(BACKWARD_SOURCE, _BACKWARD_LAUNCH, _BACKWARD_ARGTYPES)
    call(lib, _BACKWARD_LAUNCH, dev, DTYPE_CODE[dtype], x.data_ptr(),
         dy.data_ptr(), g32.data_ptr(), mu.data_ptr(), psi.data_ptr(),
         dx.data_ptr(), dg.data_ptr(), db.data_ptr(), pdg.data_ptr(),
         pdb.data_ptr(), n, c, br, bc)
    bn_backward.launches += 1
    return dx, dg, db


bn_backward.launches = 0


class BatchNormFn(torch.autograd.Function):
    """``y`` of ``impl.bn_forward(x, gamma, beta)``, whose backward is
    ``impl.bn_backward`` (Algorithm 1) on the saved ``x``, ``gamma`` and
    the forward's ``mu`` and ``psi``.  ``impl`` is any object with those
    two functions, ``kernels.ops`` by default; ``dgamma`` and ``dbeta``
    come back in the parameters' types."""

    @staticmethod
    def forward(ctx, x, gamma, beta, impl=None):
        if impl is None:
            from . import ops as impl
        y, mu, psi = impl.bn_forward(x, gamma, beta)
        ctx.save_for_backward(x, gamma, mu, psi)
        ctx.impl, ctx.beta_dtype = impl, beta.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mu, psi = ctx.saved_tensors
        dx, dg, db = ctx.impl.bn_backward(x, dy.contiguous(), gamma, mu, psi)
        return dx, dg.to(gamma.dtype), db.to(ctx.beta_dtype), None

"""Training batch-norm forward over ``x`` (N_eff, C), the (h*w*n, c) rows
of the paper's Sec. V-C: ``(y, mu, psi)`` with ``psi = rsqrt(var + eps)``
and ``y = (x - mu) * psi * gamma + beta``; ``mu`` and ``psi`` are
float32, ``y`` takes x's type.

On CUDA tensors it launches the hand-written kernels of
``csrc/bn_forward.cu`` (the port of the JAX package's Pallas
``bn_forward_pallas``; the source says how they are laid out and what
bounds them), which compute ``var = E[x^2] - mu^2`` as that kernel does.
On CPU tensors it runs ``bn_forward_ref``, the plain version, with the
oracle's two-pass variance.  The backward (Algorithm 1) is not ported yet.
"""
from __future__ import annotations

import ctypes

import torch

from ._dispatch import (DTYPE_CODE, call, device_kind, library,
                        positive_int, same_dtype)
from .ref import bn_backward_ref, bn_forward_ref

__all__ = ["bn_forward", "bn_forward_ref", "bn_backward_ref"]

SOURCE = "bn_forward.cu"
_LAUNCH = "bn_forward_launch"
_ARGTYPES = (ctypes.c_int,) + (ctypes.c_void_p,) * 8 + (
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_void_p)
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
    positive_int("bn_forward", block_rows=block_rows, block_c=block_c)
    if block_c > MAX_BLOCK_C:
        raise ValueError(f"bn_forward: block_c {block_c} exceeds "
                         f"{MAX_BLOCK_C} channels a block")
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

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
sources say how they are laid out and what bounds them): one persistent
cooperative launch a call, one block an SM, laid out by
``core.gpu_model.bn_layout``.  A block keeps as many of its rows (of x;
of x and dy) in shared memory as fit, between the reduction over rows
and the elementwise pass.  The forward's statistics are shifted sums
merged by Chan's formula in a fixed order (the batch mean and biased
variance, stable at large mean shifts, the same bits in every run); the
backward recomputes ``x^`` in float32 in its second part rather than
storing it.  On CPU tensors they run ``bn_forward_ref`` (the oracle's
two-pass variance) and ``bn_backward_ref``, the plain versions.

``bn_forward.launches`` and ``bn_backward.launches`` count the calls
that launch; ``.routes`` counts them by route: ``"vector"`` (16-byte
accesses) or ``"scalar"`` (a channel count no multiple of the pack width,
or a base that is not 16-byte aligned).  A grid the card cannot hold
resident at once raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.gpu_model import (BN_BLOCKS_PER_SM, SM_COUNT, BnLayout,
                              bn_layout)
from ._dispatch import (DTYPE_CODE, call, device_kind, library,
                        positive_int, same_dtype)
from .ref import bn_backward_ref, bn_forward_ref

__all__ = ["bn_forward", "bn_backward", "BatchNormFn", "bn_forward_ref",
           "bn_backward_ref"]

SOURCE = "bn_forward.cu"
_LAUNCH = "bn_forward_launch"
_ARGTYPES = (ctypes.c_int,) + (ctypes.c_void_p,) * 7 + (
    ctypes.c_longlong,) + (ctypes.c_int,) * 7 + (ctypes.c_float,
                                                  ctypes.c_void_p)
BACKWARD_SOURCE = "bn_backward.cu"
_BACKWARD_LAUNCH = "bn_backward_launch"
_BACKWARD_ARGTYPES = (ctypes.c_int,) + (ctypes.c_void_p,) * 9 + (
    ctypes.c_longlong,) + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)
_OCCUPANCY_ARGTYPES = (ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int))
MAX_BLOCK_C = 1024      # block_c's bound; validated, sets nothing on the card
EPS = 1e-5


@functools.lru_cache(maxsize=None)
def _resident(source: str, device: int, dtype: int, vec: int,
              smem: int) -> int:
    """Blocks of the kernel the card holds at once, from the occupancy
    API and the card's SM count."""
    lib = library(source, source.replace(".cu", "_launch"),
                  _ARGTYPES if source == SOURCE else _BACKWARD_ARGTYPES)
    fn = getattr(lib, source.replace(".cu", "_occupancy"))
    fn.restype = ctypes.c_int
    fn.argtypes = _OCCUPANCY_ARGTYPES
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(dtype, vec, smem, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"{source}: occupancy query failed ({err})")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return blocks.value * sms


def _check_resident(fn: str, source: str, device: torch.device,
                    dtype: torch.dtype, lay: BnLayout) -> None:
    """Raise unless the card holds ``lay``'s grid resident at once, as
    ``gpu_model`` assumes (``BN_BLOCKS_PER_SM`` x ``SM_COUNT``)."""
    have = _resident(source, device.index if device.index is not None
                     else torch.cuda.current_device(), DTYPE_CODE[dtype],
                     lay.vec, lay.smem)
    if have < lay.blocks or have < BN_BLOCKS_PER_SM * SM_COUNT:
        raise RuntimeError(
            f"{fn}: the card holds {have} blocks of {lay.smem} bytes at "
            f"once; the layout needs {lay.blocks} (gpu_model assumes "
            f"{BN_BLOCKS_PER_SM} an SM on {SM_COUNT} SMs)")


def bn_forward(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               block_rows: int = 256, block_c: int = 128):
    """``(y, mu, psi)`` of ``x`` (N_eff, C) and ``gamma``, ``beta`` (C,).

    ``block_rows`` and ``block_c`` were the Pallas kernel's VMEM tile;
    they are validated (positive, ``block_c`` at most 1024) and set
    nothing on the card, where ``core.gpu_model.bn_layout`` lays the call
    out from the shape, type and alignment alone."""
    kind = device_kind("bn_forward", {"x": x, "gamma": gamma, "beta": beta})
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
    lay = bn_layout(n, c, x.element_size(), 1,
                    aligned=x.data_ptr() % 16 == 0)
    dev = x.device
    _check_resident("bn_forward", SOURCE, dev, x.dtype, lay)
    y = torch.empty_like(x)
    mu = torch.empty(c, dtype=torch.float32, device=dev)
    psi = torch.empty(c, dtype=torch.float32, device=dev)
    part = torch.empty((3 * lay.row_groups + 2) * c, dtype=torch.float32,
                       device=dev)
    g32, b32 = gamma.float(), beta.float()
    lib = library(SOURCE, _LAUNCH, _ARGTYPES)
    call(lib, _LAUNCH, dev, DTYPE_CODE[x.dtype], x.data_ptr(),
         g32.data_ptr(), b32.data_ptr(), y.data_ptr(), mu.data_ptr(),
         psi.data_ptr(), part.data_ptr(), n, c, lay.vec, lay.group_c,
         lay.channel_groups, lay.row_groups, lay.rows_kept, lay.smem, EPS)
    bn_forward.launches += 1
    bn_forward.routes[lay.route] += 1
    return y, mu, psi


bn_forward.launches = 0
bn_forward.routes = {"vector": 0, "scalar": 0}


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

    ``block_rows`` and ``block_c`` are validated as by ``bn_forward`` and
    set nothing on the card (``core.gpu_model.bn_layout`` with x and dy
    on chip)."""
    kind = device_kind("bn_backward", {"x": x, "dy": dy, "gamma": gamma,
                                       "mu": mu, "psi": psi})
    same_dtype("bn_backward", {"x": x, "dy": dy})
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
    aligned = x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
    lay = bn_layout(n, c, x.element_size(), 2, aligned=aligned)
    dev = x.device
    _check_resident("bn_backward", BACKWARD_SOURCE, dev, x.dtype, lay)
    dx = torch.empty_like(x)
    dg = torch.empty(c, dtype=torch.float32, device=dev)
    db = torch.empty(c, dtype=torch.float32, device=dev)
    part = torch.empty(2 * lay.row_groups * c, dtype=torch.float32,
                       device=dev)
    g32 = gamma.float()
    lib = library(BACKWARD_SOURCE, _BACKWARD_LAUNCH, _BACKWARD_ARGTYPES)
    call(lib, _BACKWARD_LAUNCH, dev, DTYPE_CODE[x.dtype], x.data_ptr(),
         dy.data_ptr(), g32.data_ptr(), mu.data_ptr(), psi.data_ptr(),
         dx.data_ptr(), dg.data_ptr(), db.data_ptr(), part.data_ptr(), n, c,
         lay.vec, lay.group_c, lay.channel_groups, lay.row_groups,
         lay.rows_kept, lay.smem)
    bn_backward.launches += 1
    bn_backward.routes[lay.route] += 1
    return dx, dg, db


bn_backward.launches = 0
bn_backward.routes = {"vector": 0, "scalar": 0}


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

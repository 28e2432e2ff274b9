"""Fused DSE grid reduction: outer-add + first-occurrence argmin/argmax.

The DSE cost grid is separable — ``costs[i, j] = conv[s3_of[i], j'] +
simd[v_of[i], j']`` after the bandwidth columns have been pre-gathered —
so the best/worst search never needs the [n_size x n_bw] grid in memory.
``grid_minmax`` computes ``[min, argmin, max, argmax]`` over that virtual
grid (flat row-major indices, ties to the first occurrence).

On a CUDA tensor it launches the hand-written kernel in
``csrc/grid_minmax.cu`` (the port of the JAX package's Pallas kernel
``kernels/reduce.py::grid_minmax_pallas``; the source says how it is laid
out and what bounds it).  On a CPU tensor it runs ``grid_minmax_ref``, the
plain PyTorch version: gather, add, first-occurrence ``argmin``/
``argmax``.  No other device is taken, and a failed build or launch
raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools

import torch

SOURCE = "grid_minmax.cu"
# stage-1 blocks per streaming multiprocessor: enough blocks in flight to
# cover the card, few enough partials for the single-block stage 2
BLOCKS_PER_SM = 4


def _check(conv_rows: torch.Tensor, simd_rows: torch.Tensor,
           s3_of: torch.Tensor, v_of: torch.Tensor) -> None:
    for name, t, dim in (("conv_rows", conv_rows, 2),
                         ("simd_rows", simd_rows, 2),
                         ("s3_of", s3_of, 1), ("v_of", v_of, 1)):
        if t.dtype != torch.int64:
            raise TypeError(f"{name} must be int64, got {t.dtype}")
        if t.dim() != dim:
            raise ValueError(f"{name} must be {dim}-D, got shape "
                             f"{tuple(t.shape)}")
        if t.device != conv_rows.device:
            raise ValueError(f"{name} is on {t.device}, conv_rows on "
                             f"{conv_rows.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if conv_rows.shape[1] != simd_rows.shape[1]:
        raise ValueError(f"operand panels differ in width: "
                         f"{conv_rows.shape[1]} vs {simd_rows.shape[1]}")
    if s3_of.shape[0] != v_of.shape[0]:
        raise ValueError(f"s3_of and v_of differ in length: "
                         f"{s3_of.shape[0]} vs {v_of.shape[0]}")
    if s3_of.shape[0] == 0 or conv_rows.shape[1] == 0:
        raise ValueError("empty grid: no candidate to reduce")


def grid_minmax_ref(conv_rows: torch.Tensor, simd_rows: torch.Tensor,
                    s3_of: torch.Tensor, v_of: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``grid_minmax``: materialise the grid,
    then first-occurrence ``argmin``/``argmax`` over its flat view."""
    _check(conv_rows, simd_rows, s3_of, v_of)
    flat = (conv_rows[s3_of] + simd_rows[v_of]).reshape(-1)
    bi, wi = torch.argmin(flat), torch.argmax(flat)
    return torch.stack([flat[bi], bi, flat[wi], wi])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ._ext import load_library
    lib = load_library(SOURCE)
    lib.grid_minmax_launch.restype = ctypes.c_int
    lib.grid_minmax_launch.argtypes = (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
    lib.grid_minmax_partial_bytes.restype = ctypes.c_int
    lib.grid_minmax_error_string.restype = ctypes.c_char_p
    lib.grid_minmax_error_string.argtypes = (ctypes.c_int,)
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_shape(n_rows: int, n_sm: int) -> tuple:
    """``(rows_per_block, n_blocks)`` of stage 1: about ``BLOCKS_PER_SM``
    blocks per SM, each over a contiguous tile of rows."""
    rows_per_block = -(-n_rows // (BLOCKS_PER_SM * n_sm))
    return rows_per_block, -(-n_rows // rows_per_block)


def _grid_minmax_cuda(conv_rows, simd_rows, s3_of, v_of) -> torch.Tensor:
    lib = _library()
    n_rows, nb = s3_of.shape[0], conv_rows.shape[1]
    dev = conv_rows.device
    rows_per_block, n_blocks = launch_shape(
        n_rows, _sm_count(dev.index if dev.index is not None
                          else torch.cuda.current_device()))
    words = lib.grid_minmax_partial_bytes() // 8
    partials = torch.empty((n_blocks, words), dtype=torch.int64, device=dev)
    out = torch.empty(4, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.grid_minmax_launch(
            conv_rows.data_ptr(), simd_rows.data_ptr(), s3_of.data_ptr(),
            v_of.data_ptr(), n_rows, nb, rows_per_block, n_blocks,
            partials.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("grid_minmax launch failed: "
                           + lib.grid_minmax_error_string(err).decode())
    grid_minmax.launches += 1
    return out


def grid_minmax(conv_rows: torch.Tensor, simd_rows: torch.Tensor,
                s3_of: torch.Tensor, v_of: torch.Tensor) -> torch.Tensor:
    """``[min, argmin, max, argmax]`` (int64[4], on the operands' device)
    over the virtual grid ``conv_rows[s3_of[i], :] + simd_rows[v_of[i],
    :]``, flat row-major indices, ties to the first occurrence.

    ``conv_rows``/``simd_rows`` are the column-pre-gathered operand
    panels ([n_size_triples x n_bw] and [n_vmem x n_bw]); ``s3_of``/
    ``v_of`` are the int64 per-size-row projections into them.  All four
    are contiguous int64 tensors on one device.  A CUDA device launches
    the kernel (counted in ``grid_minmax.launches``), the CPU runs
    ``grid_minmax_ref``; any other device raises."""
    _check(conv_rows, simd_rows, s3_of, v_of)
    kind = conv_rows.device.type
    if kind == "cuda":
        return _grid_minmax_cuda(conv_rows, simd_rows, s3_of, v_of)
    if kind == "cpu":
        return grid_minmax_ref(conv_rows, simd_rows, s3_of, v_of)
    raise ValueError(f"grid_minmax runs on cuda or cpu tensors, not {kind}")


grid_minmax.launches = 0

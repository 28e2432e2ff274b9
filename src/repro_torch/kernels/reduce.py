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
import threading
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..core.gpu_model import SMEM_BYTES, SMEM_PER_SM

SOURCE = "grid_minmax.cu"
# The kernel's shape (csrc/grid_minmax.cu: kTile, kMaxItemRows, kThreads,
# and the blocks an SM of its __launch_bounds__), held equal to the
# source by tests/test_torch_reduce.py.
TILE_COLS = 64
MAX_ITEM_ROWS = 256
WARPS = 8
BLOCKS_PER_SM = 4
# shared memory of an item: each row's s3_of, v_of (int64), (run slot,
# SIMD row) and run start (int32); each run slot's conv pairs (32 lanes x
# 16 bytes)
ROW_BYTES = 28
SLOT_BYTES = 512
# dynamic shared memory a block may take: the card's limit less 1 KB for
# the kernel's static merge scratch; and what keeps BLOCKS_PER_SM blocks
# on an SM (a quarter of its 228 KB, less the 1 KB the card reserves for
# each block and the static scratch)
SMEM_LIMIT = SMEM_BYTES - 1024
BLOCK_SMEM = SMEM_PER_SM // BLOCKS_PER_SM - 2048
ROUTES = ("shared", "global")
PARTIAL_BYTES = 32          # one block's (min_v, min_i, max_v, max_i)


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


class _CPlan(ctypes.Structure):
    """``csrc/grid_minmax.cu::Plan``, field for field."""
    _fields_ = [("n_rows", ctypes.c_longlong), ("nb", ctypes.c_longlong),
                ("n_simd", ctypes.c_longlong),
                ("rows_per_item", ctypes.c_longlong),
                ("col_tiles", ctypes.c_longlong),
                ("n_items", ctypes.c_longlong),
                ("route", ctypes.c_int),  # analysis: allow[X64002] 0 or 1
                ("run_slots", ctypes.c_int),  # analysis: allow[X64002] <= 256
                ("blocks", ctypes.c_int),  # analysis: allow[X64002] one wave
                ("smem", ctypes.c_int)]  # analysis: allow[X64002] <= 227 KB


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ._ext import load_library
    return _bind(load_library(SOURCE))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``SOURCE``) with its entry points typed and its
    structures checked against this module's."""
    lib.grid_minmax_launch.restype = ctypes.c_int
    # the last argument is the device index
    lib.grid_minmax_launch.argtypes = \
        (ctypes.c_void_p,) * 9 + (ctypes.c_int,)  # analysis: allow[X64002]
    for name in ("grid_minmax_partial_bytes", "grid_minmax_plan_bytes"):
        getattr(lib, name).restype = ctypes.c_int
    lib.grid_minmax_error_string.restype = ctypes.c_char_p
    lib.grid_minmax_error_string.argtypes = \
        (ctypes.c_int,)  # analysis: allow[X64002] an error code
    if lib.grid_minmax_plan_bytes() != ctypes.sizeof(_CPlan) or \
            lib.grid_minmax_partial_bytes() != PARTIAL_BYTES:
        raise RuntimeError(f"{SOURCE}: the library's Plan or partial "
                           f"differs from reduce.py's")
    return lib


@dataclass(frozen=True)
class MinmaxPlan:
    """How one call is laid out on the card.  The grid is cut into work
    items of ``rows_per_item`` rows x ``TILE_COLS`` columns, item ``k``
    covering row chunk ``k // col_tiles`` and column tile ``k %
    col_tiles``; block ``b`` walks items ``b, b + blocks, ...``.  An item
    takes its runs of equal ``s3_of`` in windows of at most ``run_slots``
    runs, each copied in two halves, the second in flight while the first
    is walked.
    ``route`` is ``"shared"`` when the tile's columns of every SIMD row
    fit in shared memory beside the item's staged rows and at least
    ``WARPS`` run slots, else ``"global"``; ``smem`` is the dynamic shared
    memory a block takes."""
    route: str
    rows_per_item: int
    col_tiles: int
    row_chunks: int
    run_slots: int
    blocks: int
    smem: int

    @property
    def n_items(self) -> int:
        return self.col_tiles * self.row_chunks


def launch_plan(n_rows: int, nb: int, n_simd: int, n_sm: int) -> MinmaxPlan:
    """The plan of an ``n_rows`` x ``nb`` grid over ``n_simd`` SIMD rows on
    a card of ``n_sm`` SMs: at most ``BLOCKS_PER_SM`` blocks an SM (one
    wave), as many row chunks as the column tiles leave room for (at
    least a row for each warp of an item where the rows allow it), and as
    many run slots as keep ``BLOCKS_PER_SM`` blocks on an SM
    (``BLOCK_SMEM``), or failing that as fit in one block."""
    col_tiles = -(-nb // TILE_COLS)
    cap = BLOCKS_PER_SM * n_sm
    chunks = max(1, min(cap // col_tiles, -(-n_rows // WARPS)))
    rows = min(-(-n_rows // chunks), MAX_ITEM_ROWS)
    chunks = -(-n_rows // rows)
    staged = ROW_BYTES * rows
    tile = n_simd * TILE_COLS * 8
    shared = staged + tile + SLOT_BYTES * min(rows, WARPS) <= SMEM_LIMIT
    fixed = staged + (tile if shared else 0)
    slots = (BLOCK_SMEM - fixed) // SLOT_BYTES
    if slots < min(rows, WARPS):
        slots = (SMEM_LIMIT - fixed) // SLOT_BYTES
    slots = min(rows, slots)
    return MinmaxPlan(route="shared" if shared else "global",
                      rows_per_item=rows, col_tiles=col_tiles,
                      row_chunks=chunks, run_slots=slots,
                      blocks=min(col_tiles * chunks, cap),
                      smem=fixed + SLOT_BYTES * slots)


@functools.lru_cache(maxsize=4096)
def _cuda_plan(n_rows: int, nb: int, n_simd: int, index: int):
    """``(MinmaxPlan, its C struct's address, the struct)`` for device
    ``index``."""
    n_sm = torch.cuda.get_device_properties(index).multi_processor_count
    plan = launch_plan(n_rows, nb, n_simd, n_sm)
    c_plan = _CPlan(n_rows, nb, n_simd, plan.rows_per_item, plan.col_tiles,
                    plan.n_items, ROUTES.index(plan.route), plan.run_slots,
                    plan.blocks, plan.smem)
    return plan, ctypes.addressof(c_plan), c_plan


_WORKSPACES: Dict[Tuple[int, int], tuple] = {}  # guarded-by: _WS_LOCK
_WS_LOCK = threading.Lock()


def _workspace(index: int, stream: int) -> tuple:
    """``(partials, ticket)`` device addresses of the workspace of
    ``stream`` on device ``index``: one partial for each block of the
    largest grid, then a ticket that the kernel leaves at 0.  Made
    (zeroed) once, under a lock, by the first call on that stream from
    any thread; calls on one stream run in order on the device, whichever
    thread launched them, so they share it."""
    with _WS_LOCK:
        ws = _WORKSPACES.get((index, stream))
        if ws is None:
            n_sm = torch.cuda.get_device_properties(index) \
                .multi_processor_count
            words = BLOCKS_PER_SM * n_sm * PARTIAL_BYTES // 8
            buf = torch.zeros(words + 1, dtype=torch.int64,
                              device=torch.device("cuda", index))
            ptr = buf.data_ptr()
            ws = _WORKSPACES[(index, stream)] = (ptr, ptr + 8 * words, buf)
        return ws


def _grid_minmax_cuda(conv_rows, simd_rows, s3_of, v_of) -> torch.Tensor:
    index = conv_rows.device.index
    plan, c_plan, _ = _cuda_plan(s3_of.shape[0], conv_rows.shape[1],
                                 simd_rows.shape[0], index)
    stream = torch.cuda.current_stream(index).cuda_stream
    partials, ticket, _ = _workspace(index, stream)
    out = torch.empty(4, dtype=torch.int64, device=conv_rows.device)
    lib = _library()
    err = lib.grid_minmax_launch(
        c_plan, conv_rows.data_ptr(), simd_rows.data_ptr(),
        s3_of.data_ptr(), v_of.data_ptr(), partials, ticket,
        out.data_ptr(), stream, index)
    if err != 0:
        raise RuntimeError("grid_minmax launch failed: "
                           + lib.grid_minmax_error_string(err).decode())
    _count(plan.route)
    return out


_COUNT_LOCK = threading.Lock()


def _count(route: str) -> None:
    """Count one launch on ``route``.  Searches may launch from several
    threads at once (a service's pricing threads), so the read-modify-
    write of the counters is taken under a lock."""
    with _COUNT_LOCK:
        grid_minmax.launches += 1
        grid_minmax.routes[route] += 1


def grid_minmax(conv_rows: torch.Tensor, simd_rows: torch.Tensor,
                s3_of: torch.Tensor, v_of: torch.Tensor) -> torch.Tensor:
    """``[min, argmin, max, argmax]`` (int64[4], on the operands' device)
    over the virtual grid ``conv_rows[s3_of[i], :] + simd_rows[v_of[i],
    :]``, flat row-major indices, ties to the first occurrence.

    ``conv_rows``/``simd_rows`` are the column-pre-gathered operand
    panels ([n_size_triples x n_bw] and [n_vmem x n_bw]); ``s3_of``/
    ``v_of`` are the int64 per-size-row projections into them.  All four
    are contiguous int64 tensors on one device.  A CUDA device launches
    the kernel (counted in ``grid_minmax.launches`` and, by the route
    ``launch_plan`` gives it, in ``grid_minmax.routes``), the CPU runs
    ``grid_minmax_ref``; any other device raises."""
    _check(conv_rows, simd_rows, s3_of, v_of)
    kind = conv_rows.device.type
    if kind == "cuda":
        return _grid_minmax_cuda(conv_rows, simd_rows, s3_of, v_of)
    if kind == "cpu":
        return grid_minmax_ref(conv_rows, simd_rows, s3_of, v_of)
    raise ValueError(f"grid_minmax runs on cuda or cpu tensors, not {kind}")


grid_minmax.launches = 0
grid_minmax.routes = dict.fromkeys(ROUTES, 0)

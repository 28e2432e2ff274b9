"""Design-space exploration — paper Sec. VII-B, tensorized.

Exhaustively evaluates the 8-parameter space (sizes and DRAM bandwidths of
WBuf, IBuf, OBuf, VMem) under total-SRAM and total-bandwidth budgets, with
every candidate within +/-15% of the budgets (paper's setup).  The grid is
evaluated as dense array operations, never as a per-candidate Python loop.

Evaluation order of the tensorized engine:

  1. The candidate tuples are projected onto the model's separable axes:
     Conv cost depends only on (wbuf, ibuf, obuf) x (bw_w, bw_i, bw_o);
     non-Conv cost only on (vmem) x (bw_v).  Unique size triples / vmem
     values and unique bandwidth triples / bw_v values are enumerated once.
  2. For every unique size triple one ``ConvTable`` is built (tiling
     depends on buffer *sizes* only, so the per-tile quantities — compute
     cycles, per-stream bits, Table-IV case-occurrence counts — are
     bandwidth-independent); its ``cycles_batch`` then evaluates *all*
     bandwidth triples in one broadcasted ``np.maximum`` reduction over
     [n_bw_triples x n_layers], yielding a ``[n_size_triples x
     n_bw_triples]`` conv-cost matrix.  A ``[n_vmem x n_bw_v]`` SIMD-cost
     matrix is built the same way from ``SimdTable.cycles_batch``.
  3. The full grid cost is the outer addition of the two matrices routed
     through the budget-filtered candidate lists with ``np.ix_`` fancy
     indexing — one ``[n_size_tuples x n_bw_tuples]`` int64 array whose
     row-major order equals the legacy (size-outer, bandwidth-inner)
     iteration order.
  4. best/worst come from flat ``argmin``/``argmax`` (first occurrence ==
     legacy strict-inequality tie-break); the within-``frac`` frontier
     comes from a boolean mask.  ``DSEPoint`` objects are materialized
     only for the frontier, never for the full grid.

Tables are deduplicated across identically-shaped layers (names/phases
stripped) and — via ``search_many`` — shared across networks, so a Table IX
style multi-network sweep builds each per-size table once.  On top of
that, ``get_conv_table``/``get_simd_table`` keep a *process-lifetime*
cache keyed on (hw invariants, size triple, layer-shape+phase tuple), so
repeated ``search`` calls — a sweep over budgets whose size-tuple windows
overlap, or a training sweep after an inference sweep — rebuild nothing
(``table_cache_stats`` exposes the hit counters).

Training workloads (``training=True`` on ``search``/``search_many``) are
expanded once through ``expand_training_graph`` (Table I) and evaluated on
the same grid engine; the per-network *per-phase* matrices built alongside
the totals make the cost of any candidate phase-resolvable —
``DSEResult.phase_breakdown`` splits any grid point's cycles into
conv fwd / dX / dW and SIMD fwd / bwd (exactly partitioning the total),
and ``phase_profile`` does the same for a single fixed configuration.

The tensorized path is numerically identical to brute force: the retained
reference implementation ``search_reference`` walks the same grid with
scalar calls, and the equivalence is asserted bit-for-bit in
``tests/test_dse_equivalence.py``.

The search is front-end-pluggable (``method=...``): the exhaustive grid
above is the default and the reference; ``method="refine"`` dispatches to
the budget-constrained local search in ``core.optimize``, which drives
the same batched tables off the power-of-two lattice down to arbitrary
integer splits (see that module's docstring).

Both tables carry, alongside the cycle quantities, the per-layer *energy*
tensors of Sec. VI — busy cycles, SRAM bits per buffer, DRAM bits — all
bandwidth-independent, so any ``Objective`` (energy, EDP, power caps; see
``core.objectives``) prices the whole grid from one vectorized
``compute_energy_batch`` application and a cycles sweep followed by an
energy sweep rebuilds nothing.  The serial default builds uncached
per-size-triple tables through ``batch_build_conv_tables`` — the tiling
derivation and every table quantity are computed for ALL candidate size
triples in one vectorized pass per layer (``derive_conv_tilings_batch``
+ ``conv_quantities_batch``), never one Python walk per (triple, layer)
pair; ``prefetch_conv_tables`` remains the many-core option that fans
scalar builds across worker processes (``Study(workers=N)`` /
``$REPRO_DSE_WORKERS``).  Both are bit-identical to the scalar loop.

The preferred entry point is ``repro_torch.core.study.Study`` (Workload /
Objective / Study); ``search``/``search_many`` below survive as thin
deprecation shims over a default ``Study``, bit-identical under the
default cycles objective.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from dataclasses import dataclass, field, replace
import functools
from functools import lru_cache
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from . import faultinject
from .backward import expand_training_graph
from .conv_model import (conv_dram_bits, conv_multipliers,
                         conv_quantities_batch, conv_segment_quantities,
                         conv_sram_bits)
from .energy import DEFAULT_ENERGY, EnergyModel, compute_energy_batch
from .gemm_model import (gemm_dram_bits, gemm_multipliers,
                         gemm_quantities_batch, gemm_segment_quantities,
                         gemm_sram_bits)
from .hardware import KB, HardwareSpec
from .store import active_store, env_float, reset_store_stats, store_stats
from .objectives import Cycles, MetricBatch, Objective, resolve_objective
from .layers import ConvLayer, GemmLayer, SimdLayer
from .simd_model import simd_part_tile_bits, simulate_simd
from .tiling import (_conv_hw_key, _conv_layer_key,
                     _derive_conv_tiling_arrays,
                     _derive_gemm_tiling_arrays, _gemm_layer_key,
                     _simd_hw_key, _simd_layer_key, ceil_div,
                     make_conv_tiling, make_gemm_tiling,
                     make_simd_tiling, prefill_simd_tilings)

Layer = Union[ConvLayer, GemmLayer, SimdLayer]

SIZES_KB = (32, 64, 128, 256, 512, 1024, 2048)
BWS = (32, 64, 128, 256, 512, 1024, 2048)

FRONTIER_FRAC = 0.15          # paper's "economic design" band (Table X)

BACKEND_ENV = "REPRO_DSE_BACKEND"
# Grid-evaluation backends of the exhaustive front-end: host numpy (the
# reference), on-device torch reductions, and the torch path with
# best/worst routed through the hand-written CUDA grid min/max kernel
# (``repro_torch.core.gridtorch``, ``repro_torch.kernels.reduce``).  All
# three are pinned bit-identical; the fused one is the default.
DSE_BACKENDS = ("numpy", "torch", "torch-fused")
DEFAULT_BACKEND = "torch-fused"


def resolve_backend(backend: Optional[str]) -> str:
    """``None`` -> ``$REPRO_DSE_BACKEND`` (else ``"torch-fused"``); a
    known name passes through.  An unknown name raises, from the argument
    or the environment alike: a backend name of the JAX package
    (``jax``, ``jax-fused``) must not quietly put a search on the host."""
    source = "backend"
    if backend is None:
        backend = os.environ.get(BACKEND_ENV) or DEFAULT_BACKEND
        source = f"${BACKEND_ENV}"
    if backend not in DSE_BACKENDS:
        raise ValueError(f"unknown DSE backend {backend!r} (from "
                         f"{source}); known: {', '.join(DSE_BACKENDS)}")
    return backend


def _load_gridtorch():
    """Import the torch backend on demand (keeps ``import
    repro_torch.core.dse`` torch-free for numpy-only use)."""
    from . import gridtorch
    return gridtorch


# ---------------------------------------------------------------------------
# Vectorized per-size-triple cost tables
# ---------------------------------------------------------------------------

class ConvTable:
    """Bandwidth-independent per-layer quantities for fixed buffer sizes.

    Arrays are indexed [layer]; ``cycles_batch`` broadcasts them against a
    vector of bandwidth triples.  Alongside the cycle quantities the table
    carries the per-layer *energy* tensors — busy (compute) cycles, SRAM
    bits per buffer, total DRAM bits (Secs. IV-C, Table III) — so any
    energy-aware objective prices a candidate from the same cached table
    that prices its cycles (a cycles sweep followed by an energy sweep
    rebuilds nothing).
    """

    @classmethod
    def _from_columns(cls, phases: Tuple[str, ...],
                      cols: Mapping[str, np.ndarray],
                      busy: np.ndarray, dram: np.ndarray,
                      sram: Dict[str, np.ndarray]) -> "ConvTable":
        """Assemble a table from precomputed per-layer column vectors (the
        ``batch_build_conv_tables`` path: one vectorized quantity pass per
        layer covers every size triple, and each table is a column slice).
        Field values are bit-identical to the scalar ``__init__``."""
        t = cls.__new__(cls)
        t.phases = phases
        t.c_tile = cols["c_tile"]
        t.o1, t.o2 = cols["o1"], cols["o2"]
        t.o4, t.o5 = cols["o4"], cols["o5"]
        t.w_bits, t.wb_bits = cols["w_bits"], cols["wb_bits"]
        t.i_bits = cols["i_bits"]
        t.ps_bits, t.pls_bits = cols["ps_bits"], cols["pls_bits"]
        t.busy, t.dram, t.sram = busy, dram, sram
        return t

    def __init__(self, hw: HardwareSpec, layers: Sequence[ConvLayer]):
        n = len(layers)
        self.phases: Tuple[str, ...] = tuple(l.phase for l in layers)
        self.c_tile = np.zeros(n)          # compute cycles / tile (incl. PSO)
        self.o1 = np.zeros(n); self.o2 = np.zeros(n)
        self.o4 = np.zeros(n); self.o5 = np.zeros(n)
        self.w_bits = np.zeros(n); self.wb_bits = np.zeros(n)
        self.i_bits = np.zeros(n)
        self.ps_bits = np.zeros(n); self.pls_bits = np.zeros(n)
        self.busy = np.zeros(n, dtype=np.int64)      # compute cycles (C_SA)
        self.dram = np.zeros(n, dtype=np.int64)      # all streams, bits
        self.sram = {buf: np.zeros(n, dtype=np.int64)
                     for buf in ("wbuf", "ibuf", "obuf", "bbuf")}
        for x, layer in enumerate(layers):
            t = make_conv_tiling(hw, layer)
            m = conv_multipliers(layer, t)
            q = conv_segment_quantities(hw, layer, t, m)
            self.c_tile[x] = q.c_tile
            self.o1[x], self.o2[x] = q.o1, q.o2
            self.o4[x], self.o5[x] = q.o4, q.o5
            self.w_bits[x], self.wb_bits[x] = q.w_bits, q.wb_bits
            self.i_bits[x] = q.i_bits
            self.ps_bits[x], self.pls_bits[x] = q.ps_bits, q.pls_bits
            self.busy[x] = q.c_tile * (q.o1 + q.o2 + q.o4 + q.o5)
            self.dram[x] = sum(conv_dram_bits(hw, layer, t, m).values())
            for buf, bits in conv_sram_bits(hw, layer, t, m).items():
                self.sram[buf][x] = bits

    def layer_cycles_batch(self, bw_w, bw_i, bw_o) -> np.ndarray:
        """Per-layer segment-summed cycles for a *vector* of bandwidth
        triples: returns float64 [n_bw_triples x n_layers]."""
        bw_w = np.asarray(bw_w, dtype=float).reshape(-1, 1)
        bw_i = np.asarray(bw_i, dtype=float).reshape(-1, 1)
        bw_o = np.asarray(bw_o, dtype=float).reshape(-1, 1)
        t_w = np.ceil(self.w_bits / bw_w)
        t_wb = np.ceil(self.wb_bits / bw_w)
        t_i = np.ceil(self.i_bits / bw_i)
        t_ps = np.ceil(self.ps_bits / bw_o)
        t_pls = np.ceil(self.pls_bits / bw_o)
        c = self.c_tile
        seg1 = np.maximum(np.maximum(c, t_i), t_ps)
        seg2 = np.maximum(np.maximum(c, t_i), t_pls)
        seg4 = np.maximum(np.maximum(np.maximum(c, t_w), t_i), t_pls)
        seg5 = np.maximum(np.maximum(np.maximum(c, t_wb), t_i), t_ps)
        return (self.o1 * seg1 + self.o2 * seg2
                + self.o4 * seg4 + self.o5 * seg5)

    def cycles_batch(self, bw_w, bw_i, bw_o) -> np.ndarray:
        """Network cycles for a vector of bandwidth triples: int64 [m]."""
        return self.layer_cycles_batch(bw_w, bw_i, bw_o) \
            .sum(axis=1).astype(np.int64)

    def phase_cycles_batch(self, bw_w, bw_i, bw_o) -> Dict[str, np.ndarray]:
        """Per-phase cycles (reduced over the phase's layer columns) for a
        vector of bandwidth triples: {phase: int64 [m]}.  The phase sums
        partition the layer set, so they add up exactly to
        ``cycles_batch`` (all quantities are integers in float64)."""
        per_layer = self.layer_cycles_batch(bw_w, bw_i, bw_o)
        out: Dict[str, np.ndarray] = {}
        for ph in dict.fromkeys(self.phases):
            cols = [x for x, p in enumerate(self.phases) if p == ph]
            out[ph] = per_layer[:, cols].sum(axis=1).astype(np.int64)
        return out

    def cycles(self, bw_w: int, bw_i: int, bw_o: int) -> int:
        return int(self.cycles_batch([bw_w], [bw_i], [bw_o])[0])


class SimdTable:
    """Bandwidth-independent SIMD quantities for a fixed VMem size.

    Rows are indexed [layer-part]; ``layer_rows`` records each layer's
    contiguous row slice so a union table can serve several networks.
    """

    def __init__(self, hw: HardwareSpec, layers: Sequence[SimdLayer]):
        rows_b4, rows_b1, rows_mhwn, rows_mc = [], [], [], []
        self.compute = 0
        self.phases: Tuple[str, ...] = tuple(l.phase for l in layers)
        self.layer_compute: List[int] = []
        self.layer_rows: List[Tuple[int, int]] = []
        layer_dram, layer_sram = [], []
        for layer in layers:
            t = make_simd_tiling(hw, layer)
            st = simulate_simd(hw, layer, t, stall_model="no_stall")
            self.compute += st.compute_cycles
            self.layer_compute.append(st.compute_cycles)
            layer_dram.append(st.dram_total_bits)
            layer_sram.append(st.sram_total_bits)
            m_h = ceil_div(layer.h, t.T_h); m_w = ceil_div(layer.w, t.T_w)
            m_n = ceil_div(layer.n, t.T_n); m_c = ceil_div(layer.c, t.T_c)
            start = len(rows_b4)
            for part in layer.parts:
                b4, b1 = simd_part_tile_bits(hw, part, t)
                rows_b4.append(b4); rows_b1.append(b1)
                rows_mhwn.append(m_h * m_w * m_n); rows_mc.append(m_c)
            self.layer_rows.append((start, len(rows_b4)))
        self.b4 = np.array(rows_b4, dtype=float)
        self.b1 = np.array(rows_b1, dtype=float)
        self.m_hwn = np.array(rows_mhwn, dtype=float)
        self.m_c = np.array(rows_mc, dtype=float)
        # Energy tensors (Eqs. 34-36): busy cycles C_SIMD, VMem bits, DRAM
        # bits per layer — bandwidth-independent, cached with the table.
        self.busy = np.array(self.layer_compute, dtype=np.int64)
        self.dram = np.array(layer_dram, dtype=np.int64)
        self.sram_vmem = np.array(layer_sram, dtype=np.int64)

    def row_stall_batch(self, bw_v) -> np.ndarray:
        """Per-row stall cycles for a vector of bw_v: float64 [m x n_rows]."""
        bw = np.asarray(bw_v, dtype=float).reshape(-1, 1)
        return (np.ceil(self.b4 / bw) * self.m_hwn
                + np.where(self.b1 > 0, np.ceil(self.b1 / bw), 0.0)) * self.m_c

    def cycles_batch(self, bw_v) -> np.ndarray:
        """Network cycles for a vector of bw_v values: int64 [m]."""
        return (self.compute
                + self.row_stall_batch(bw_v).sum(axis=1)).astype(np.int64)

    def phase_cycles_batch(self, bw_v) -> Dict[str, np.ndarray]:
        """Per-phase cycles for a vector of bw_v values: {phase: int64 [m]}.
        Partitions ``cycles_batch`` exactly, like the ConvTable variant."""
        row_stall = self.row_stall_batch(bw_v)
        out: Dict[str, np.ndarray] = {}
        for ph in dict.fromkeys(self.phases):
            ids = [x for x, p in enumerate(self.phases) if p == ph]
            rows = [r for i in ids for r in range(*self.layer_rows[i])]
            compute = sum(self.layer_compute[i] for i in ids)
            out[ph] = (compute + row_stall[:, rows].sum(axis=1)) \
                .astype(np.int64)
        return out

    def cycles(self, bw_v: int) -> int:
        return int(self.cycles_batch([bw_v])[0])


class GemmTable(ConvTable):
    """Bandwidth-independent per-layer GEMM quantities for fixed buffer
    sizes.  The stall-segment reduction and the energy tensor layout are
    the systolic-array ones ``ConvTable`` already implements (a GEMM is
    the conv model's unit-kernel specialization), so every batch accessor
    — ``layer_cycles_batch``/``cycles_batch``/``phase_cycles_batch`` and
    the ``_from_columns`` assembly path — is inherited unchanged; only
    the per-layer quantity derivation differs.  ``layer.count`` is folded
    into the occurrence counts and energy tensors (all linear), never the
    per-block volumes the segment maxima read."""

    def __init__(self, hw: HardwareSpec, layers: Sequence[GemmLayer]):
        n = len(layers)
        self.phases: Tuple[str, ...] = tuple(l.phase for l in layers)
        self.c_tile = np.zeros(n)
        self.o1 = np.zeros(n); self.o2 = np.zeros(n)
        self.o4 = np.zeros(n); self.o5 = np.zeros(n)
        self.w_bits = np.zeros(n); self.wb_bits = np.zeros(n)
        self.i_bits = np.zeros(n)
        self.ps_bits = np.zeros(n); self.pls_bits = np.zeros(n)
        self.busy = np.zeros(n, dtype=np.int64)
        self.dram = np.zeros(n, dtype=np.int64)
        self.sram = {buf: np.zeros(n, dtype=np.int64)
                     for buf in ("wbuf", "ibuf", "obuf", "bbuf")}
        for x, layer in enumerate(layers):
            t = make_gemm_tiling(hw, layer)
            m = gemm_multipliers(layer, t)
            q = gemm_segment_quantities(hw, layer, t, m)
            cnt = layer.count
            self.c_tile[x] = q.c_tile
            self.o1[x], self.o2[x] = q.o1 * cnt, q.o2 * cnt
            self.o4[x], self.o5[x] = q.o4 * cnt, q.o5 * cnt
            self.w_bits[x], self.wb_bits[x] = q.w_bits, q.wb_bits
            self.i_bits[x] = q.i_bits
            self.ps_bits[x], self.pls_bits[x] = q.ps_bits, q.pls_bits
            self.busy[x] = q.c_tile * (q.o1 + q.o2 + q.o4 + q.o5) * cnt
            self.dram[x] = sum(gemm_dram_bits(hw, layer, t, m).values()) * cnt
            for buf, bits in gemm_sram_bits(hw, layer, t, m).items():
                self.sram[buf][x] = bits * cnt


# ---------------------------------------------------------------------------
# Process-lifetime table cache
#
# A ConvTable depends only on the conv-relevant hardware invariants
# (buffer sizes, bit widths, array dims — exactly ``_conv_hw_key``) and the
# layer *shapes*; a SimdTable on (vmem, b_in, K) — the tiling key — plus
# b_out and the ALU latency table, which its tile bits / compute bake in.
# Caching them across ``search`` calls means a Table VIII style sweep over
# *budgets* rebuilds nothing for the size triples the budget windows share,
# and a training sweep reuses every table an earlier inference sweep of the
# same shapes built.  Phases ride along in the key so a cached table's
# ``phases`` vector always matches its caller's layer list.
# ---------------------------------------------------------------------------

_CONV_TABLE_CACHE: Dict[tuple, ConvTable] = {}   # guarded-by: _CACHE_LOCK
_SIMD_TABLE_CACHE: Dict[tuple, SimdTable] = {}   # guarded-by: _CACHE_LOCK
_GEMM_TABLE_CACHE: Dict[tuple, GemmTable] = {}   # guarded-by: _CACHE_LOCK
_PREFETCHED_UNTOUCHED: set = set()               # guarded-by: _CACHE_LOCK
# One lock guards every L1 dict, the miss-accounting set, and the stat
# counters: the serving subsystem (``repro.serve``) drives these caches
# from a dispatcher thread plus arbitrary client threads, where unlocked
# check-then-build races would double-build tables and `+=` on the
# counters would lose updates.  Reentrant because a build path may call
# back into another getter (e.g. a store load validating against the
# cache).  Held across table construction on purpose: the barrier test
# in tests/test_dse_threadsafety.py pins "concurrent identical gets
# build exactly once".
_CACHE_LOCK = threading.RLock()
_TABLE_CACHE_STATS = {"conv_hits": 0, "conv_misses": 0,  # guarded-by: _CACHE_LOCK
                      "simd_hits": 0, "simd_misses": 0,
                      "gemm_hits": 0, "gemm_misses": 0,
                      "conv_parallel_builds": 0,
                      "conv_batch_builds": 0,
                      "gemm_batch_builds": 0,
                      "conv_builds": 0, "simd_builds": 0, "gemm_builds": 0}


def _conv_table_key(hw: HardwareSpec, layers: Sequence[ConvLayer]) -> tuple:
    return (_conv_hw_key(hw),
            tuple((_conv_layer_key(l), l.phase) for l in layers))


def _gemm_table_key(hw: HardwareSpec, layers: Sequence[GemmLayer]) -> tuple:
    # the conv hw invariants are exactly the GEMM-relevant ones (buffer
    # sizes, bit widths, array dims); count scales the table linearly so
    # it must key alongside the shape
    return (_conv_hw_key(hw),
            tuple((_gemm_layer_key(l), l.count, l.phase) for l in layers))


def _simd_table_key(hw: HardwareSpec, layers: Sequence[SimdLayer]) -> tuple:
    return (_simd_hw_key(hw), hw.b_out, tuple(sorted(hw.lat.items())),
            tuple((_simd_layer_key(l), l.phase) for l in layers))


def get_conv_table(hw: HardwareSpec, layers: Sequence[ConvLayer]) -> ConvTable:
    """Shared, process-lifetime ConvTable constructor — the L1 over the
    optional persistent store (``core.store``): an in-memory miss first
    consults the active store (validated, checksummed load) and only
    builds on a store miss, writing the fresh table back.  Thread-safe:
    the whole check-then-build is one critical section, so concurrent
    identical gets build exactly once."""
    key = _conv_table_key(hw, layers)
    with _CACHE_LOCK:
        t = _CONV_TABLE_CACHE.get(key)
        if t is not None:
            if key in _PREFETCHED_UNTOUCHED:
                # First retrieval of a parallel-prefetched (or store-seeded)
                # table: account it as the miss the caller's serial loop
                # would have recorded, so hit/miss statistics are identical
                # between workers=0/>1 and store on/off.
                _PREFETCHED_UNTOUCHED.discard(key)
                _TABLE_CACHE_STATS["conv_misses"] += 1
            else:
                _TABLE_CACHE_STATS["conv_hits"] += 1
            return t
        _TABLE_CACHE_STATS["conv_misses"] += 1
        store = active_store()
        if store is not None:
            t = store.load("conv", key, ConvTable)
            if t is not None:
                _CONV_TABLE_CACHE[key] = t
                return t
        _TABLE_CACHE_STATS["conv_builds"] += 1
        t = _CONV_TABLE_CACHE[key] = ConvTable(hw, layers)
        if store is not None:
            store.save("conv", key, t)
        return t


def get_simd_table(hw: HardwareSpec, layers: Sequence[SimdLayer]) -> SimdTable:
    """Shared, process-lifetime SimdTable constructor (L1 over the
    optional persistent store, like ``get_conv_table``; same
    single-build thread-safety contract)."""
    key = _simd_table_key(hw, layers)
    with _CACHE_LOCK:
        t = _SIMD_TABLE_CACHE.get(key)
        if t is not None:
            _TABLE_CACHE_STATS["simd_hits"] += 1
            return t
        _TABLE_CACHE_STATS["simd_misses"] += 1
        store = active_store()
        if store is not None:
            t = store.load("simd", key, SimdTable)
            if t is not None:
                _SIMD_TABLE_CACHE[key] = t
                return t
        _TABLE_CACHE_STATS["simd_builds"] += 1
        t = _SIMD_TABLE_CACHE[key] = SimdTable(hw, layers)
        if store is not None:
            store.save("simd", key, t)
        return t


def get_gemm_table(hw: HardwareSpec, layers: Sequence[GemmLayer]) -> GemmTable:
    """Shared, process-lifetime GemmTable constructor (L1 over the
    optional persistent store, like ``get_conv_table`` — store kind
    ``"gemm"``).  Seeded entries from ``batch_build_gemm_tables`` count a
    miss on first retrieval, keeping statistics path-independent."""
    key = _gemm_table_key(hw, layers)
    with _CACHE_LOCK:
        t = _GEMM_TABLE_CACHE.get(key)
        if t is not None:
            if key in _PREFETCHED_UNTOUCHED:
                _PREFETCHED_UNTOUCHED.discard(key)
                _TABLE_CACHE_STATS["gemm_misses"] += 1
            else:
                _TABLE_CACHE_STATS["gemm_hits"] += 1
            return t
        _TABLE_CACHE_STATS["gemm_misses"] += 1
        store = active_store()
        if store is not None:
            t = store.load("gemm", key, GemmTable)
            if t is not None:
                _GEMM_TABLE_CACHE[key] = t
                return t
        _TABLE_CACHE_STATS["gemm_builds"] += 1
        t = _GEMM_TABLE_CACHE[key] = GemmTable(hw, layers)
        if store is not None:
            store.save("gemm", key, t)
        return t


def _build_conv_table(args) -> ConvTable:
    """Worker-process entry point for the parallel table prefetch.  The
    optional third element is a fault directive injected (and consumed)
    on the submission side by ``core.faultinject`` — ``times=N`` there
    means exactly N poisoned *tasks*, independent of worker count."""
    hw, layers, directive = args if len(args) == 3 else (*args, None)
    if directive is not None:
        kind = directive[0]
        if kind == "exc":
            raise RuntimeError("faultinject: injected worker exception")
        if kind == "crash":
            os._exit(17)
        if kind == "hang":
            time.sleep(directive[1])
    return ConvTable(hw, layers)


def batch_build_conv_tables(hws: Sequence[HardwareSpec],
                            layers: Sequence[ConvLayer]) -> None:
    """Build the ConvTables for every hardware variant not already cached
    in ONE vectorized pass per layer, and seed the shared cache.

    This is the serial fast path (and the default): the greedy tiling
    derivation runs once per layer over the whole candidate axis — in
    struct-of-arrays form (``_derive_conv_tiling_arrays``), so no
    per-candidate ``ConvTiling`` objects are ever materialized — the
    per-layer table quantities are computed as candidate-axis vectors
    (``conv_quantities_batch``), and each table is a column slice: no
    per-(size triple, layer) Python walk anywhere.  Bit-identical to the scalar ``ConvTable`` loop; each
    seeded table is accounted as a miss on first retrieval (exactly like
    the fork-pool prefetch), so cache statistics match the legacy serial
    path.  ``table_cache_stats()['conv_batch_builds']`` counts the tables
    built this way."""
    layers = list(layers)
    if not layers:
        # zero-conv networks (pure GEMM/SIMD transformers): nothing to
        # derive, and an empty table would only pollute the cache
        return
    with _CACHE_LOCK:
        _batch_build_conv_tables_locked(hws, layers)


def _batch_build_conv_tables_locked(hws: Sequence[HardwareSpec],  # holds-lock: _CACHE_LOCK
                                    layers: List[ConvLayer]) -> None:
    # one layers-part tuple shared by every per-variant cache key (the
    # inner tuple of _conv_table_key, hoisted out of the hw loop)
    lpart = tuple((_conv_layer_key(l), l.phase) for l in layers)
    missing = [(key, hw) for hw in dict.fromkeys(hws)
               if (key := (_conv_hw_key(hw), lpart))
               not in _CONV_TABLE_CACHE]
    store = active_store()
    if store is not None and missing:
        # L2 pass: validated store loads seed the L1 before anything is
        # rebuilt.  Loaded entries count a miss on first retrieval (the
        # _PREFETCHED_UNTOUCHED contract), keeping the legacy counters
        # identical whether the store is on or off.
        still = []
        for key, hw in missing:
            t = store.load("conv", key, ConvTable)
            if t is None:
                still.append((key, hw))
            else:
                _CONV_TABLE_CACHE[key] = t
                _PREFETCHED_UNTOUCHED.add(key)
        missing = still
    if not missing:
        return
    base = missing[0][1]
    tail = _conv_hw_key(base)[3:]       # bbuf, bit widths, J, K
    if any(key[0][3:] != tail for key, _ in missing):
        raise ValueError("batch_build_conv_tables requires all hardware "
                         "variants to share every conv invariant except "
                         "the wbuf/ibuf/obuf sizes")
    triples = [(hw.wbuf, hw.ibuf, hw.obuf) for _, hw in missing]
    n_l, n_t = len(layers), len(triples)
    f_fields = ("c_tile", "o1", "o2", "o4", "o5", "w_bits", "wb_bits",
                "i_bits", "ps_bits", "pls_bits")
    mats = {f: np.zeros((n_l, n_t)) for f in f_fields}
    busy = np.zeros((n_l, n_t), dtype=np.int64)
    dram = np.zeros((n_l, n_t), dtype=np.int64)
    sram = {buf: np.zeros((n_l, n_t), dtype=np.int64)
            for buf in ("wbuf", "ibuf", "obuf", "bbuf")}
    for x, layer in enumerate(layers):
        q = conv_quantities_batch(
            base, layer, _derive_conv_tiling_arrays(base, triples, layer))
        for f in f_fields:
            mats[f][x] = q[f]
        busy[x] = q["busy"]
        dram[x] = q["dram"]
        for buf in sram:
            sram[buf][x] = q["sram"][buf]
    phases = tuple(l.phase for l in layers)
    # column views into the [n_layers x n_triples] matrices (a few KB per
    # matrix — cheaper than 14 copies per table, and numerically identical)
    for i, (key, _hw) in enumerate(missing):
        t = _CONV_TABLE_CACHE[key] = ConvTable._from_columns(
            phases, {f: mats[f][:, i] for f in f_fields},
            busy[:, i], dram[:, i],
            {buf: sram[buf][:, i] for buf in sram})
        _PREFETCHED_UNTOUCHED.add(key)
        _TABLE_CACHE_STATS["conv_batch_builds"] += 1
        _TABLE_CACHE_STATS["conv_builds"] += 1
        if store is not None:
            store.save("conv", key, t)


def batch_build_gemm_tables(hws: Sequence[HardwareSpec],
                            layers: Sequence[GemmLayer]) -> None:
    """Build the GemmTables for every hardware variant not already cached
    in ONE vectorized pass per layer (the GEMM twin of
    ``batch_build_conv_tables``: struct-of-arrays tiling derivation +
    ``gemm_quantities_batch``, each table a column slice), and seed the
    shared cache.  Bit-identical to the scalar ``GemmTable`` loop; an
    empty layer union is a clean no-op."""
    layers = list(layers)
    if not layers:
        return
    with _CACHE_LOCK:
        _batch_build_gemm_tables_locked(hws, layers)


def _batch_build_gemm_tables_locked(hws: Sequence[HardwareSpec],  # holds-lock: _CACHE_LOCK
                                    layers: List[GemmLayer]) -> None:
    lpart = tuple((_gemm_layer_key(l), l.count, l.phase) for l in layers)
    missing = [(key, hw) for hw in dict.fromkeys(hws)
               if (key := (_conv_hw_key(hw), lpart))
               not in _GEMM_TABLE_CACHE]
    store = active_store()
    if store is not None and missing:
        still = []
        for key, hw in missing:
            t = store.load("gemm", key, GemmTable)
            if t is None:
                still.append((key, hw))
            else:
                _GEMM_TABLE_CACHE[key] = t
                _PREFETCHED_UNTOUCHED.add(key)
        missing = still
    if not missing:
        return
    base = missing[0][1]
    tail = _conv_hw_key(base)[3:]       # bbuf, bit widths, J, K
    if any(key[0][3:] != tail for key, _ in missing):
        raise ValueError("batch_build_gemm_tables requires all hardware "
                         "variants to share every invariant except the "
                         "wbuf/ibuf/obuf sizes")
    triples = [(hw.wbuf, hw.ibuf, hw.obuf) for _, hw in missing]
    n_l, n_t = len(layers), len(triples)
    f_fields = ("c_tile", "o1", "o2", "o4", "o5", "w_bits", "wb_bits",
                "i_bits", "ps_bits", "pls_bits")
    mats = {f: np.zeros((n_l, n_t)) for f in f_fields}
    busy = np.zeros((n_l, n_t), dtype=np.int64)
    dram = np.zeros((n_l, n_t), dtype=np.int64)
    sram = {buf: np.zeros((n_l, n_t), dtype=np.int64)
            for buf in ("wbuf", "ibuf", "obuf", "bbuf")}
    for x, layer in enumerate(layers):
        q = gemm_quantities_batch(
            base, layer, _derive_gemm_tiling_arrays(base, triples, layer))
        for f in f_fields:
            mats[f][x] = q[f]
        busy[x] = q["busy"]
        dram[x] = q["dram"]
        for buf in sram:
            sram[buf][x] = q["sram"][buf]
    phases = tuple(l.phase for l in layers)
    for i, (key, _hw) in enumerate(missing):
        t = _GEMM_TABLE_CACHE[key] = GemmTable._from_columns(
            phases, {f: mats[f][:, i] for f in f_fields},
            busy[:, i], dram[:, i],
            {buf: sram[buf][:, i] for buf in sram})
        _PREFETCHED_UNTOUCHED.add(key)
        _TABLE_CACHE_STATS["gemm_batch_builds"] += 1
        _TABLE_CACHE_STATS["gemm_builds"] += 1
        if store is not None:
            store.save("gemm", key, t)


PREFETCH_TIMEOUT_ENV = "REPRO_DSE_BUILD_TIMEOUT"
PREFETCH_DEFAULT_TIMEOUT_S = 120.0     # per retry attempt, whole task batch
PREFETCH_RETRIES = 2                   # re-pool attempts after a failure
PREFETCH_BACKOFF_S = 0.05              # sleep base between attempts


def _fault_directive() -> Optional[tuple]:
    """Submission-side fault consumption for the parallel build tasks
    (see ``_build_conv_table``)."""
    if faultinject.fire("conv_worker_exc"):
        return ("exc",)
    if faultinject.fire("conv_worker_crash"):
        return ("crash",)
    f = faultinject.fire("conv_worker_hang")
    if f is not None:
        return ("hang", f.arg if f.arg is not None else 3600.0)
    return None


def _terminate_pool(pool) -> None:
    """Best-effort teardown of a pool that may hold hung or dead workers:
    never join (a hung worker would hang *us* — the failure mode this
    layer exists to prevent), just cancel and kill.  The workers are
    listed before the shutdown, which drops the pool's own list of them:
    a hung worker listed after it would outlive the pool, and the
    interpreter's exit would wait for it."""
    procs = list((getattr(pool, "_processes", None) or {}).values())
    try:
        pool.shutdown(wait=False, cancel_futures=True)
    except Exception:
        pass
    for proc in procs:
        try:
            proc.terminate()
        except Exception:
            pass


def prefetch_conv_tables(hws: Sequence[HardwareSpec],
                         layers: Sequence[ConvLayer],
                         workers: int, *,
                         timeout_s: Optional[float] = None,
                         retries: Optional[int] = None) -> None:
    """Build the ConvTables for every hardware variant not already cached,
    fanned out across ``workers`` processes, and seed the shared cache.

    The per-size-triple builds are independent, so the fan-out is
    embarrassingly parallel and — each build being deterministic —
    bit-identical to the serial path.  Since the serial path itself now
    vectorizes the tiling derivation and table quantities across the
    whole candidate axis (``batch_build_conv_tables``), the fork pool is
    the *many-core* option for heavy shape unions, not the default.  Each
    prefetched table is accounted as a miss on its first retrieval (not a
    hit), so cache statistics match the serial path exactly; callers with
    ``workers <= 1`` (or a single missing table, or no fork start method)
    fall back to the vectorized serial build implicitly.

    Fault tolerance: a worker that raises, hard-exits (the pool breaks),
    or hangs past the per-attempt ``timeout_s`` (default
    ``$REPRO_DSE_BUILD_TIMEOUT`` or 120 s) can neither poison the cache
    nor hang the sweep.  Completed tables are salvaged even from a
    broken or timed-out pool, failed tasks are retried on a fresh pool
    (``retries`` attempts with linear backoff), and whatever still fails
    is simply left missing — the caller's ``batch_build_conv_tables``
    pass rebuilds it serially, so the only cost of any worker fault is
    wall time.  This function never raises on worker failure."""
    if not layers:
        # zero-conv networks: never spin up a pool for an empty union
        return
    store = active_store()
    with _CACHE_LOCK:
        missing = [(key, hw) for hw in dict.fromkeys(hws)
                   if (key := _conv_table_key(hw, layers))
                   not in _CONV_TABLE_CACHE
                   and not (store is not None
                            and store.contains("conv", key))]
    if workers <= 1 or len(missing) < 2:
        return
    from concurrent.futures import TimeoutError as FutTimeout
    from concurrent.futures import ProcessPoolExecutor, as_completed
    from multiprocessing import get_context
    try:
        ctx = get_context("fork")      # cheap workers via COW; no re-import
    except ValueError:                 # platform without fork: stay serial
        return
    if timeout_s is None:
        timeout_s = env_float(PREFETCH_TIMEOUT_ENV,
                              PREFETCH_DEFAULT_TIMEOUT_S)
    if retries is None:
        retries = PREFETCH_RETRIES
    layers = tuple(layers)

    def seed(key: tuple, table: ConvTable) -> None:
        with _CACHE_LOCK:
            _CONV_TABLE_CACHE[key] = table
            _PREFETCHED_UNTOUCHED.add(key)
            _TABLE_CACHE_STATS["conv_parallel_builds"] += 1
            _TABLE_CACHE_STATS["conv_builds"] += 1
            if store is not None:
                store.save("conv", key, table)

    for attempt in range(retries + 1):
        n = min(int(workers), len(missing))
        pool = ProcessPoolExecutor(max_workers=n, mp_context=ctx)
        futs: Dict[object, Tuple[tuple, HardwareSpec]] = {}
        failed: List[Tuple[tuple, HardwareSpec]] = []
        for key, hw in missing:
            try:
                futs[pool.submit(_build_conv_table,
                                 (hw, layers, _fault_directive()))] = (key, hw)
            except Exception:          # pool already broken mid-submission
                failed.append((key, hw))
        pending = dict(futs)
        try:
            for fut in as_completed(futs, timeout=timeout_s):
                key, hw = pending.pop(fut)
                try:
                    seed(key, fut.result(timeout=0))
                except Exception:      # worker exception or broken pool
                    failed.append((key, hw))
        except FutTimeout:
            pass
        # Salvage: a timeout above abandons the iteration, but tasks that
        # finished before the deadline still carry valid tables.
        for fut, (key, hw) in pending.items():
            if fut.done():
                try:
                    seed(key, fut.result(timeout=0))
                    continue
                except Exception:
                    pass
            else:
                fut.cancel()
            failed.append((key, hw))
        _terminate_pool(pool)
        missing = failed
        if not missing:
            return
        time.sleep(PREFETCH_BACKOFF_S * (attempt + 1))
    # retries exhausted: leave the remainder to the caller's guaranteed
    # serial fallback (batch_build_conv_tables)


def table_cache_stats() -> Dict[str, object]:
    """Hit/miss counters plus current entry counts of the shared caches.
    ``by_kind`` nests the same numbers per table kind for dashboards that
    track conv and simd (and future kinds) separately.  The ``store_*``
    counters come from the persistent L2 (``core.store``): store hits
    (validated on-disk loads), misses, quarantined corruptions, LRU
    evictions and lock-wait timeouts; ``conv_builds``/``simd_builds``
    count actual table constructions across every path, so a warm-store
    sweep is assertable as "store hits only, zero builds".  The counter
    copy is taken under the cache lock, so callers (e.g. the service
    metrics snapshot in ``repro.serve``) always see a consistent cut —
    never a miss without its matching build."""
    with _CACHE_LOCK:
        stats = dict(_TABLE_CACHE_STATS,
                     conv_entries=len(_CONV_TABLE_CACHE),
                     simd_entries=len(_SIMD_TABLE_CACHE),
                     gemm_entries=len(_GEMM_TABLE_CACHE))
        stats.update(store_stats())
    stats["by_kind"] = {
        "conv": {"hits": stats["conv_hits"], "misses": stats["conv_misses"],
                 "entries": stats["conv_entries"],
                 "builds": stats["conv_builds"],
                 "parallel_builds": stats["conv_parallel_builds"],
                 "batch_builds": stats["conv_batch_builds"]},
        "simd": {"hits": stats["simd_hits"], "misses": stats["simd_misses"],
                 "entries": stats["simd_entries"],
                 "builds": stats["simd_builds"], "parallel_builds": 0,
                 "batch_builds": 0},
        "gemm": {"hits": stats["gemm_hits"], "misses": stats["gemm_misses"],
                 "entries": stats["gemm_entries"],
                 "builds": stats["gemm_builds"], "parallel_builds": 0,
                 "batch_builds": stats["gemm_batch_builds"]},
    }
    return stats


def clear_table_caches() -> None:
    """Drop all cached tables and zero the counters (benchmark fairness).
    The persistent store's *files* are untouched — surviving the death of
    the in-memory cache is their whole point — but its counters reset."""
    with _CACHE_LOCK:
        _CONV_TABLE_CACHE.clear()
        _SIMD_TABLE_CACHE.clear()
        _GEMM_TABLE_CACHE.clear()
        _PREFETCHED_UNTOUCHED.clear()
        for k in _TABLE_CACHE_STATS:
            _TABLE_CACHE_STATS[k] = 0
        reset_store_stats()


# ---------------------------------------------------------------------------
# Result types
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DSEPoint:
    sizes_kb: Tuple[int, int, int, int]     # wbuf, ibuf, obuf, vmem
    bws: Tuple[int, int, int, int]          # bw_w, bw_i, bw_o, bw_v
    cycles: int

    @property
    def total_size_kb(self) -> int:
        return sum(self.sizes_kb)

    @property
    def total_bw(self) -> int:
        return sum(self.bws)


@dataclass(frozen=True)
class PhaseBreakdown:
    """Phase-resolved cycle attribution of one design point.

    ``cycles`` maps namespaced phase keys ('conv:fwd', 'conv:bwd_dx',
    'conv:bwd_dw', 'gemm:fwd', 'gemm:bwd_dx', 'gemm:bwd_dw', 'simd:fwd',
    'simd:bwd') to cycle counts; the keys partition the layer set, so the
    values sum exactly to the point's total cycles.  Derived shares give
    the paper's Table VI style conv-vs-non-conv and fwd-vs-bwd splits for
    *any* grid candidate; GEMM phases run on the systolic array, so they
    count toward ``conv_cycles`` (the array side of the split) and are
    also exposed separately as ``gemm_cycles``."""
    cycles: Tuple[Tuple[str, int], ...]

    @classmethod
    def from_dict(cls, d: Mapping[str, int]) -> "PhaseBreakdown":
        return cls(tuple(sorted(d.items())))

    def as_dict(self) -> Dict[str, int]:
        return dict(self.cycles)

    @property
    def total(self) -> int:
        return sum(v for _, v in self.cycles)

    @property
    def conv_cycles(self) -> int:
        return sum(v for k, v in self.cycles
                   if k.startswith(("conv:", "gemm:")))

    @property
    def gemm_cycles(self) -> int:
        return sum(v for k, v in self.cycles if k.startswith("gemm:"))

    @property
    def nonconv_cycles(self) -> int:
        return sum(v for k, v in self.cycles if k.startswith("simd:"))

    @property
    def fwd_cycles(self) -> int:
        return sum(v for k, v in self.cycles if k.endswith(":fwd"))

    @property
    def bwd_cycles(self) -> int:
        return self.total - self.fwd_cycles

    @property
    def nonconv_share(self) -> float:
        t = self.total
        return self.nonconv_cycles / t if t else 0.0

    @property
    def bwd_share(self) -> float:
        t = self.total
        return self.bwd_cycles / t if t else 0.0


@dataclass(eq=False)          # ndarray field: compare grids by identity
class DSEGrid:
    """The evaluated grid: an int64 cost matrix over the budget-filtered
    candidate tuples, size tuples along rows (legacy outer loop) and
    bandwidth tuples along columns (legacy inner loop)."""
    costs: np.ndarray                        # [n_size_tuples x n_bw_tuples]
    size_tuples: List[Tuple[int, int, int, int]]
    bw_tuples: List[Tuple[int, int, int, int]]

    @property
    def n_candidates(self) -> int:
        return int(self.costs.size)

    def point(self, flat_index: int) -> DSEPoint:
        n_bw = len(self.bw_tuples)
        return DSEPoint(self.size_tuples[flat_index // n_bw],
                        self.bw_tuples[flat_index % n_bw],
                        int(self.costs.flat[flat_index]))

    def points_below(self, limit: float,
                     values: Optional[np.ndarray] = None) -> List[DSEPoint]:
        """Materialize DSEPoints whose value (cycles by default, or the
        given objective-score array) is <= limit, in grid order."""
        vals = self.costs if values is None else values
        idx = np.nonzero(vals.ravel() <= limit)[0]
        return [self.point(int(i)) for i in idx]

    def locate(self, point: DSEPoint) -> Tuple[int, int]:
        """(size-row, bandwidth-column) indices of a point's tuples."""
        if not hasattr(self, "_size_index"):
            self._size_index = {t: i for i, t in enumerate(self.size_tuples)}
            self._bw_index = {t: i for i, t in enumerate(self.bw_tuples)}
        try:
            return self._size_index[point.sizes_kb], self._bw_index[point.bws]
        except KeyError:
            raise ValueError(f"point {point} is not on this grid") from None


@dataclass(eq=False)
class _PhaseGrids:
    """Per-phase cost matrices over the same separable axes as the total
    grid: conv matrices are [n_size_triples x n_bw_triples], simd matrices
    [n_vmem x n_bw_v]; the ``*_of`` projections route any candidate's grid
    coordinates into them.  Together they phase-resolve every candidate of
    the search space without materializing per-phase full grids."""
    conv: Dict[str, np.ndarray]          # 'conv:<phase>' -> matrix
    simd: Dict[str, np.ndarray]          # 'simd:<phase>' -> matrix
    s3_of: np.ndarray
    b3_of: np.ndarray
    v_of: np.ndarray
    w_of: np.ndarray

    def breakdown_at(self, si: int, bi: int) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ph, m in self.conv.items():
            out[ph] = int(m[self.s3_of[si], self.b3_of[bi]])
        for ph, m in self.simd.items():
            out[ph] = int(m[self.v_of[si], self.w_of[bi]])
        return out


@dataclass(eq=False)
class _EnergyFields:
    """Per-candidate energy inputs over the grid's separable axes.

    The five quantities ``compute_energy`` needs — busy cycles per
    engine, SRAM bits per buffer, DRAM bits — are bandwidth-independent,
    so one vector over the unique size triples (conv side) plus one over
    the unique VMem values (SIMD side) prices the whole grid; ``grids``
    broadcasts them (via the ``s3_of``/``v_of`` row projections) against
    the cycles matrix through the vectorized energy model.  Kept on every
    grid result and applied lazily, so pure-cycles searches never pay."""
    hw: HardwareSpec
    em: EnergyModel
    conv: Dict[str, np.ndarray]          # over size triples
    simd: Dict[str, np.ndarray]          # over vmem values
    s3_of: np.ndarray
    v_of: np.ndarray
    sizes_kb: np.ndarray                 # [n_size_tuples x 4]

    def grids(self, l_total: np.ndarray) -> Dict[str, np.ndarray]:
        """The full vectorized energy report, shaped like ``l_total``
        ([n_size_tuples x n_bw_tuples] cycles): numpy for a numpy grid,
        torch tensors on its device for the torch backends' device grid
        (the columns below are gathered on the host and moved once by
        ``compute_energy_batch``)."""
        def col(v: np.ndarray) -> np.ndarray:
            return v[:, None]

        conv, simd = self.conv, self.simd
        sram_bits = {"wbuf": col(conv["wbuf"][self.s3_of]),
                     "ibuf": col(conv["ibuf"][self.s3_of]),
                     "obuf": col(conv["obuf"][self.s3_of]),
                     "bbuf": col(conv["bbuf"][self.s3_of]),
                     "vmem": col(simd["vmem"][self.v_of])}
        sram_sizes = {"wbuf": col(self.sizes_kb[:, 0] * KB),
                      "ibuf": col(self.sizes_kb[:, 1] * KB),
                      "obuf": col(self.sizes_kb[:, 2] * KB),
                      "bbuf": self.hw.bbuf,
                      "vmem": col(self.sizes_kb[:, 3] * KB)}
        return compute_energy_batch(
            self.hw, em=self.em,
            c_sa=col(conv["busy"][self.s3_of]),
            c_simd=col(simd["busy"][self.v_of]),
            l_total=l_total,
            sram_bits=sram_bits, sram_sizes=sram_sizes,
            dram_bits=col(conv["dram"][self.s3_of]
                          + simd["dram"][self.v_of]))


def _pareto_mask(cycles: np.ndarray, energy: np.ndarray) -> np.ndarray:
    """Boolean mask of the 2-D Pareto frontier (minimize both).  Weak
    dominance: of several candidates with identical (cycles, energy) the
    first in input order is kept."""
    n = len(cycles)
    order = np.lexsort((np.arange(n), energy, cycles))
    keep = np.zeros(n, dtype=bool)
    best_e = np.inf
    for i in order:
        if energy[i] < best_e:
            keep[i] = True
            best_e = energy[i]
    return keep


@dataclass
class DSEResult:
    """Outcome of one DSE run, from either search front-end.

    Grid results carry the full cost matrix (``grid``) plus the per-phase
    matrices; refine results instead carry the optimizer's evaluation
    ``archive`` (every candidate it costed, in evaluation order — the
    off-lattice analogue of the grid), its ``refine`` trace, and a
    table-backed phase attribution hook, so ``points``/``within``/
    ``economic_min_*``/``phase_breakdown`` work identically for both.
    For refine results ``worst`` is the worst *evaluated* candidate (a
    local search never visits the global worst), so ``improvement`` is a
    lower bound on the grid's best/worst ratio.

    ``objective`` names the metric the search minimized; ``best``/
    ``worst``/``points``/``within`` are all in terms of its score (for
    the default cycles objective the score IS the cycle count, so the
    legacy behavior is unchanged bit for bit).  Independently of the
    objective, every result can price any of its candidates —
    ``energy_of``/``power_of``/``edp_of``/``energy_report`` — and
    ``pareto()`` materializes the 2-D (cycles, energy) frontier."""
    best: DSEPoint
    worst: DSEPoint
    grid: Optional[DSEGrid] = field(default=None, repr=False, compare=False)
    phase_grids: Optional[_PhaseGrids] = field(
        default=None, repr=False, compare=False)
    _frontier: Optional[List[DSEPoint]] = field(
        default=None, repr=False, compare=False)
    refine: Optional["RefineTrace"] = field(
        default=None, repr=False, compare=False)
    archive: Optional[List[DSEPoint]] = field(
        default=None, repr=False, compare=False)
    _phase_at: Optional[object] = field(       # Callable[[DSEPoint], dict]
        default=None, repr=False, compare=False)
    objective: str = "cycles"
    grid_scores: Optional[np.ndarray] = field(   # None -> grid.costs
        default=None, repr=False, compare=False)
    archive_scores: Optional[List[float]] = field(  # None -> archive cycles
        default=None, repr=False, compare=False)
    _energy: Optional[_EnergyFields] = field(
        default=None, repr=False, compare=False)
    _energy_at: Optional[object] = field(      # Callable[[DSEPoint], dict]
        default=None, repr=False, compare=False)
    _energy_many: Optional[object] = field(    # Callable[[pts], E_total arr]
        default=None, repr=False, compare=False)
    _energy_grids: Optional[Dict[str, np.ndarray]] = field(
        default=None, repr=False, compare=False)
    _pareto_mask_fn: Optional[object] = field(  # Callable[(cyc, e), mask]
        default=None, repr=False, compare=False)

    @property
    def improvement(self) -> float:
        return self.worst.cycles / self.best.cycles

    @property
    def n_candidates(self) -> int:
        """Candidates whose cost was computed: the full grid for the
        exhaustive front-end, the optimizer's unique evaluations for
        refine (the denominator/numerator of the >=10x saving claim)."""
        if self.grid is not None:
            return self.grid.n_candidates
        if self.refine is not None:
            return self.refine.n_evals
        return 0

    # ---- objective scores --------------------------------------------------

    @property
    def best_score(self) -> float:
        """The minimized objective score of ``best`` (== ``best.cycles``
        for the cycles objective)."""
        return self.score_of(self.best)

    def score_of(self, point: DSEPoint) -> float:
        """The objective score of any evaluated candidate."""
        if self.grid is not None:
            if self.grid_scores is None:
                return point.cycles
            si, bi = self.grid.locate(point)
            return float(self.grid_scores[si, bi])
        if self.archive is not None:
            if self.archive_scores is None:
                return point.cycles
            return float(self.archive_scores[self._archive_index(point)])
        raise ValueError("result has no retained grid or archive")

    def _archive_index(self, point: DSEPoint) -> int:
        if not hasattr(self, "_arch_idx"):
            self._arch_idx = {(p.sizes_kb, p.bws): i
                              for i, p in enumerate(self.archive)}
        try:
            return self._arch_idx[(point.sizes_kb, point.bws)]
        except KeyError:
            raise ValueError(f"point {point} was never evaluated") from None

    # ---- energy accessors --------------------------------------------------

    def _grid_energy(self) -> Dict[str, np.ndarray]:
        if self._energy_grids is None:
            if self._energy is None:
                raise ValueError("result carries no energy tensors")
            self._energy_grids = self._energy.grids(self.grid.costs)
        return self._energy_grids

    def energy_report(self, point: Optional[DSEPoint] = None
                      ) -> Dict[str, float]:
        """The full Sec. VI energy/power breakdown of any evaluated
        candidate (default: best) — the vectorized analogue of
        ``NetworkReport.energy``, keys as in ``compute_energy``."""
        point = point if point is not None else self.best
        if self.grid is not None:
            si, bi = self.grid.locate(point)
            return {k: float(v[si, bi])
                    for k, v in self._grid_energy().items()}
        if self._energy_at is not None:
            return {k: float(v) for k, v in self._energy_at(point).items()}
        raise ValueError("result carries no energy tensors")

    def energy_of(self, point: Optional[DSEPoint] = None) -> float:
        """E_total (Joules) of any evaluated candidate (default: best)."""
        return self.energy_report(point)["E_total"]

    def power_of(self, point: Optional[DSEPoint] = None) -> float:
        """P_avg (Watts) of any evaluated candidate (default: best)."""
        return self.energy_report(point)["P_avg"]

    def edp_of(self, point: Optional[DSEPoint] = None) -> float:
        """Energy-delay product (Joule-seconds) of any candidate."""
        rep = self.energy_report(point)
        return rep["E_total"] * rep["runtime_s"]

    def pareto(self) -> List[DSEPoint]:
        """The 2-D (cycles, energy) Pareto frontier over every evaluated
        candidate, in grid/evaluation order: no frontier member is beaten
        on both metrics by any other candidate.  Configurations achieving
        the minimum cycles and the minimum energy are always represented
        (on an exact tie in one metric, the representative is the tied
        point with the better other metric)."""
        # engines may install a bit-identical accelerated mask (the torch
        # backend's vectorized sort+prefix-min vs the host walk)
        mask_fn = self._pareto_mask_fn if self._pareto_mask_fn is not None \
            else _pareto_mask
        if self.grid is not None:
            cycles = self.grid.costs.ravel()
            energy = self._grid_energy()["E_total"].ravel()
            idx = np.nonzero(mask_fn(cycles, energy))[0]
            return [self.grid.point(int(i)) for i in idx]
        if self.archive is not None:
            cycles = np.array([p.cycles for p in self.archive], dtype=float)
            if self._energy_many is not None:
                energy = np.asarray(self._energy_many(self.archive))
            else:
                energy = np.array([self.energy_of(p) for p in self.archive])
            mask = mask_fn(cycles, energy)
            return [p for p, k in zip(self.archive, mask) if k]
        raise ValueError("result has no retained grid or archive")

    # ---- frontiers ---------------------------------------------------------

    @property
    def points(self) -> List[DSEPoint]:
        """The within-15%-of-optimal frontier (paper Table X / Fig. 11),
        measured in the result's objective.  Only these points are ever
        materialized as objects; the full grid stays an array in
        ``grid.costs`` (grid results) and refine results filter their
        evaluation archive."""
        if self._frontier is None:
            self._frontier = self.within(FRONTIER_FRAC)
        return self._frontier

    def within(self, frac: float) -> List[DSEPoint]:
        """Candidates whose objective score is within ``frac`` of the
        optimum (infeasible candidates — score inf — never qualify)."""
        limit = self.best_score * (1 + frac)
        if self.grid is not None:
            return self.grid.points_below(limit, self.grid_scores)
        if self.archive is not None:
            if self.archive_scores is None:
                return [p for p in self.archive if p.cycles <= limit]
            return [p for p, s in zip(self.archive, self.archive_scores)
                    if s <= limit]
        raise ValueError("result has no retained grid or archive")

    def economic_min_sram(self, frac: float = FRONTIER_FRAC) -> DSEPoint:
        return min(self.within(frac), key=lambda p: (p.total_size_kb, p.cycles))

    def economic_min_bw(self, frac: float = FRONTIER_FRAC) -> DSEPoint:
        return min(self.within(frac),
                   key=lambda p: (p.total_bw, p.total_size_kb, p.cycles))

    def phase_breakdown(self, point: Optional[DSEPoint] = None
                        ) -> PhaseBreakdown:
        """Phase-resolved cycle attribution for any candidate (default:
        the best point).  Grid results route the point's coordinates into
        the per-phase matrices; refine results re-derive the phase sums
        through the shared cost tables, which works for *any* point —
        on-lattice or off — and still partitions the total exactly."""
        point = point if point is not None else self.best
        if self.grid is not None and self.phase_grids is not None:
            si, bi = self.grid.locate(point)
            return PhaseBreakdown.from_dict(
                self.phase_grids.breakdown_at(si, bi))
        if self._phase_at is not None:
            return PhaseBreakdown.from_dict(self._phase_at(point))
        raise ValueError("result has no retained phase grids")


# ---------------------------------------------------------------------------
# Grid construction
# ---------------------------------------------------------------------------

def _tuples(values: Sequence[int], n: int, lo: float, hi: float
            ) -> List[Tuple[int, ...]]:
    return [t for t in itertools.product(values, repeat=n)
            if lo <= sum(t) <= hi]


def _project(tuples: Sequence[tuple], sel) -> Tuple[list, np.ndarray]:
    """Unique projections of the candidate tuples (first-seen order) and
    the per-candidate index into that unique list."""
    uniq: Dict[object, int] = {}
    idx = np.empty(len(tuples), dtype=np.intp)
    out: list = []
    for i, t in enumerate(tuples):
        key = sel(t)
        j = uniq.get(key)
        if j is None:
            j = uniq[key] = len(out)
            out.append(key)
        idx[i] = j
    return out, idx


def _norm_conv(layer: ConvLayer) -> ConvLayer:
    """Strip fields the cost model never reads, so identically-shaped
    layers share one table column."""
    return replace(layer, name="", phase="fwd", kind="conv")


def _norm_simd(layer: SimdLayer) -> SimdLayer:
    return replace(layer, name="", phase="fwd", pool_r=0, pool_s=0)


def _norm_gemm(layer: GemmLayer) -> GemmLayer:
    """Strip fields the cost model never reads (``param`` only gates the
    training expansion; ``count`` scales the cost so it stays) — a dW
    GEMM shape-equal to some fwd GEMM shares its table column."""
    return replace(layer, name="", phase="fwd", param=True)


class _GridEngine:
    """Shared batched cost tables for one or more networks.

    Builds each per-size-triple ``ConvTable`` / per-vmem ``SimdTable`` once
    over the *union* of unique layer shapes across all networks; per-network
    costs are column gathers over the union arrays (same value sequence as a
    dedicated per-network table, hence bit-identical sums).
    """

    def __init__(self, hw_base: HardwareSpec,
                 nets: Mapping[str, Sequence[Layer]]):
        self.hw = hw_base
        self._conv_union: List[ConvLayer] = []
        self._simd_union: List[SimdLayer] = []
        self._gemm_union: List[GemmLayer] = []
        conv_index: Dict[ConvLayer, int] = {}
        simd_index: Dict[SimdLayer, int] = {}
        gemm_index: Dict[GemmLayer, int] = {}
        self.conv_cols: Dict[str, List[int]] = {}
        self.simd_ids: Dict[str, List[int]] = {}
        self.gemm_cols: Dict[str, List[int]] = {}
        # Per-network per-phase column/id lists.  Dedup is by *shape* (phase
        # stripped), so a fwd conv and a shape-identical dX conv share one
        # table column but are attributed to their own phases here.
        self.conv_phase_cols: Dict[str, Dict[str, List[int]]] = {}
        self.simd_phase_ids: Dict[str, Dict[str, List[int]]] = {}
        self.gemm_phase_cols: Dict[str, Dict[str, List[int]]] = {}
        for name, net in nets.items():
            ccols: List[int] = []
            sids: List[int] = []
            gcols: List[int] = []
            pcols: Dict[str, List[int]] = {}
            pids: Dict[str, List[int]] = {}
            gpcols: Dict[str, List[int]] = {}
            for layer in net:
                if isinstance(layer, ConvLayer):
                    k = _norm_conv(layer)
                    j = conv_index.get(k)
                    if j is None:
                        j = conv_index[k] = len(self._conv_union)
                        self._conv_union.append(k)
                    ccols.append(j)
                    pcols.setdefault(f"conv:{layer.phase}", []).append(j)
                elif isinstance(layer, GemmLayer):
                    k = _norm_gemm(layer)
                    j = gemm_index.get(k)
                    if j is None:
                        j = gemm_index[k] = len(self._gemm_union)
                        self._gemm_union.append(k)
                    gcols.append(j)
                    gpcols.setdefault(f"gemm:{layer.phase}", []).append(j)
                else:
                    k = _norm_simd(layer)
                    j = simd_index.get(k)
                    if j is None:
                        j = simd_index[k] = len(self._simd_union)
                        self._simd_union.append(k)
                    sids.append(j)
                    pids.setdefault(f"simd:{layer.phase}", []).append(j)
            self.conv_cols[name] = ccols
            self.simd_ids[name] = sids
            self.gemm_cols[name] = gcols
            self.conv_phase_cols[name] = pcols
            self.simd_phase_ids[name] = pids
            self.gemm_phase_cols[name] = gpcols

    def conv_matrices(self, s3s: Sequence[Tuple[int, int, int]],
                      b3s: Sequence[Tuple[int, int, int]],
                      workers: int = 0
                      ) -> Tuple[Dict[str, np.ndarray],
                                 Dict[str, Dict[str, np.ndarray]],
                                 Dict[str, Dict[str, np.ndarray]]]:
        """Per-network [n_size_triples x n_bw_triples] conv-cost matrices:
        (totals, per-phase, energy fields).  Totals are computed over the
        full column list exactly as before the phase split (same summation
        order, hence bit-identical to the scalar reference); phase matrices
        partition them.  The energy fields are per-network vectors over the
        size triples — busy cycles, SRAM bits per buffer, DRAM bits — the
        bandwidth-independent half of the Sec. VI model.  Uncached tables
        are built up front: ``workers > 1`` fans scalar builds out across
        processes, and whatever remains is batch-built serially in one
        vectorized pass per layer (``batch_build_conv_tables``) before
        the per-triple loop walks the cache."""
        bw_w = np.array([b[0] for b in b3s], dtype=float)
        bw_i = np.array([b[1] for b in b3s], dtype=float)
        bw_o = np.array([b[2] for b in b3s], dtype=float)
        mats = {name: np.zeros((len(s3s), len(b3s)), dtype=np.int64)
                for name in self.conv_cols}
        # Single-phase networks (all inference sweeps): the one phase's
        # column list IS the total's, so alias the totals matrix instead of
        # re-reducing every row.
        pmats = {name: {ph: np.zeros((len(s3s), len(b3s)), dtype=np.int64)
                        for ph in phases} if len(phases) > 1
                 else {ph: mats[name] for ph in phases}
                 for name, phases in self.conv_phase_cols.items()}
        efields = {name: {k: np.zeros(len(s3s), dtype=np.int64)
                          for k in ("busy", "wbuf", "ibuf", "obuf",
                                    "bbuf", "dram")}
                   for name in self.conv_cols}
        if not self._conv_union:
            # zero-conv networks (pure GEMM/SIMD): the zeroed matrices
            # and empty per-phase dicts ARE the conv contribution — never
            # build or fetch an empty-union table
            return mats, pmats, efields
        hws = [self.hw.replace(wbuf=wb * KB, ibuf=ib * KB, obuf=ob * KB)
               for wb, ib, ob in s3s]
        if workers > 1:
            prefetch_conv_tables(hws, self._conv_union, workers)
        batch_build_conv_tables(hws, self._conv_union)
        for si, hw in enumerate(hws):
            table = get_conv_table(hw, self._conv_union)
            per_layer = table.layer_cycles_batch(bw_w, bw_i, bw_o)
            for name, cols in self.conv_cols.items():
                if cols:
                    mats[name][si] = per_layer[:, cols].sum(axis=1) \
                        .astype(np.int64)
                    e = efields[name]
                    e["busy"][si] = table.busy[cols].sum()
                    e["dram"][si] = table.dram[cols].sum()
                    for buf in ("wbuf", "ibuf", "obuf", "bbuf"):
                        e[buf][si] = table.sram[buf][cols].sum()
                pcs = self.conv_phase_cols[name]
                if len(pcs) > 1:
                    for ph, pc in pcs.items():
                        pmats[name][ph][si] = per_layer[:, pc].sum(axis=1) \
                            .astype(np.int64)
        return mats, pmats, efields

    def simd_matrices(self, vmems: Sequence[int], bw_vs: Sequence[int]
                      ) -> Tuple[Dict[str, np.ndarray],
                                 Dict[str, Dict[str, np.ndarray]],
                                 Dict[str, Dict[str, np.ndarray]]]:
        """Per-network [n_vmem x n_bw_v] SIMD-cost matrices:
        (totals, per-phase, energy fields over the vmem values)."""
        bw_v = np.array(bw_vs, dtype=float)
        mats = {name: np.zeros((len(vmems), len(bw_vs)), dtype=np.int64)
                for name in self.simd_ids}
        # Same single-phase aliasing as conv_matrices.
        pmats = {name: {ph: np.zeros((len(vmems), len(bw_vs)), dtype=np.int64)
                        for ph in phases} if len(phases) > 1
                 else {ph: mats[name] for ph in phases}
                 for name, phases in self.simd_phase_ids.items()}
        efields = {name: {k: np.zeros(len(vmems), dtype=np.int64)
                          for k in ("busy", "vmem", "dram")}
                   for name in self.simd_ids}
        if not self._simd_union:
            # SIMD-free networks: zeroed contribution, no empty tables
            return mats, pmats, efields
        # One vectorized derivation per layer covers every VMem candidate
        # before the per-size loop (the table builds then hit the cache).
        prefill_simd_tilings(self.hw, [vm * KB for vm in vmems],
                             self._simd_union)
        for vi, vm in enumerate(vmems):
            table = get_simd_table(self.hw.replace(vmem=vm * KB),
                                   self._simd_union)
            row_stall = table.row_stall_batch(bw_v)

            def net_cycles(ids: List[int]) -> np.ndarray:
                rows = [r for i in ids
                        for r in range(*table.layer_rows[i])]
                compute = sum(table.layer_compute[i] for i in ids)
                return (compute + row_stall[:, rows].sum(axis=1)) \
                    .astype(np.int64)

            for name, ids in self.simd_ids.items():
                if ids:
                    mats[name][vi] = net_cycles(ids)
                    e = efields[name]
                    e["busy"][vi] = table.busy[ids].sum()
                    e["vmem"][vi] = table.sram_vmem[ids].sum()
                    e["dram"][vi] = table.dram[ids].sum()
                pis = self.simd_phase_ids[name]
                if len(pis) > 1:
                    for ph, pi in pis.items():
                        pmats[name][ph][vi] = net_cycles(pi)
        return mats, pmats, efields

    def gemm_matrices(self, s3s: Sequence[Tuple[int, int, int]],
                      b3s: Sequence[Tuple[int, int, int]]
                      ) -> Tuple[Dict[str, np.ndarray],
                                 Dict[str, Dict[str, np.ndarray]],
                                 Dict[str, Dict[str, np.ndarray]]]:
        """Per-network [n_size_triples x n_bw_triples] GEMM-cost matrices
        over the SAME separable axes as ``conv_matrices`` (GEMMs live on
        the systolic array: WBuf/IBuf/OBuf sizes, w/i/o bandwidths), so
        the caller outer-adds them into the conv matrices before the grid
        composition.  Same (totals, per-phase, energy fields) contract;
        tables are batch-built serially in one vectorized pass per layer
        (``batch_build_gemm_tables``)."""
        bw_w = np.array([b[0] for b in b3s], dtype=float)
        bw_i = np.array([b[1] for b in b3s], dtype=float)
        bw_o = np.array([b[2] for b in b3s], dtype=float)
        mats = {name: np.zeros((len(s3s), len(b3s)), dtype=np.int64)
                for name in self.gemm_cols}
        # Same single-phase aliasing as conv_matrices.
        pmats = {name: {ph: np.zeros((len(s3s), len(b3s)), dtype=np.int64)
                        for ph in phases} if len(phases) > 1
                 else {ph: mats[name] for ph in phases}
                 for name, phases in self.gemm_phase_cols.items()}
        efields = {name: {k: np.zeros(len(s3s), dtype=np.int64)
                          for k in ("busy", "wbuf", "ibuf", "obuf",
                                    "bbuf", "dram")}
                   for name in self.gemm_cols}
        if not self._gemm_union:
            return mats, pmats, efields
        hws = [self.hw.replace(wbuf=wb * KB, ibuf=ib * KB, obuf=ob * KB)
               for wb, ib, ob in s3s]
        batch_build_gemm_tables(hws, self._gemm_union)
        for si, hw in enumerate(hws):
            table = get_gemm_table(hw, self._gemm_union)
            per_layer = table.layer_cycles_batch(bw_w, bw_i, bw_o)
            for name, cols in self.gemm_cols.items():
                if cols:
                    mats[name][si] = per_layer[:, cols].sum(axis=1) \
                        .astype(np.int64)
                    e = efields[name]
                    e["busy"][si] = table.busy[cols].sum()
                    e["dram"][si] = table.dram[cols].sum()
                    for buf in ("wbuf", "ibuf", "obuf", "bbuf"):
                        e[buf][si] = table.sram[buf][cols].sum()
                pcs = self.gemm_phase_cols[name]
                if len(pcs) > 1:
                    for ph, pc in pcs.items():
                        pmats[name][ph][si] = per_layer[:, pc].sum(axis=1) \
                            .astype(np.int64)
        return mats, pmats, efields


# ---------------------------------------------------------------------------
# Search front-ends
#
# ``search``/``search_many`` dispatch on ``method`` through a registry of
# pluggable front-ends.  Every front-end receives the (already
# training-expanded) networks plus the budget/grid description and returns
# per-network ``DSEResult``s:
#
#   * "grid"   — the tensorized exhaustive sweep below (the default and
#                the reference: bit-identical to ``search_reference``).
#   * "refine" — the budget-constrained local search in ``core.optimize``
#                (seeded multi-start coordinate descent with successive
#                lattice refinement down to arbitrary integer splits),
#                registered lazily on first use; it prices on the host.
# ---------------------------------------------------------------------------

SEARCH_METHODS: Dict[str, object] = {}


def register_search_method(name: str, fn) -> None:
    """Register a search front-end under ``method=name``.  ``fn`` is
    called as ``fn(hw_base, nets, size_budget_kb, bw_budget, sizes=...,
    bws=..., tol=..., lower_bound=..., refine=..., objective=...,
    em=..., workers=...)`` and must return a ``{name: DSEResult}``
    mapping whose results are scored in the given ``Objective``.  If
    ``fn`` additionally accepts a ``backend=...`` keyword (or
    ``**kwargs``), a ``Study`` forwards its grid-evaluation backend
    (``DSE_BACKENDS``); front-ends without the parameter are called
    without it."""
    SEARCH_METHODS[name] = fn


def _grid_search_many(hw_base: HardwareSpec,
                      nets: Mapping[str, Sequence[Layer]],
                      size_budget_kb: int, bw_budget: int, *,
                      sizes: Sequence[int], bws: Sequence[int],
                      tol: float, lower_bound: bool,
                      refine=None, objective: Optional[Objective] = None,
                      em: EnergyModel = DEFAULT_ENERGY,
                      workers: int = 0,
                      backend: Optional[str] = None,
                      device=None) -> Dict[str, DSEResult]:
    """The tensorized exhaustive front-end (``method="grid"``).

    ``backend`` picks where the grid *reductions* run (``DSE_BACKENDS``:
    ``"numpy"`` on the host, ``"torch"`` torch reductions on ``device``,
    ``"torch-fused"`` (the default) with best/worst through the CUDA
    grid min/max kernel; ``None`` follows ``$REPRO_DSE_BACKEND``).
    ``device`` is the torch device of the two torch backends (``None``:
    CUDA, which must be present).  Table construction, the retained
    grids, and every ``DSEResult`` accessor are shared, and the backends
    are pinned bit-identical — same best/worst/frontier/Pareto,
    int64-exact cycles."""
    if refine is not None:
        raise ValueError("refine config only applies to method='refine'")
    obj = resolve_objective(objective)
    backend = resolve_backend(backend)
    gridtorch = _load_gridtorch() if backend != "numpy" else None
    if gridtorch is not None:
        device = gridtorch.resolve_device(device)
    lo_s = size_budget_kb * (1 - tol) if lower_bound else 0
    lo_b = bw_budget * (1 - tol) if lower_bound else 0
    size_tuples = _tuples(sizes, 4, lo_s, size_budget_kb * (1 + tol))
    bw_tuples = _tuples(bws, 4, lo_b, bw_budget * (1 + tol))
    if not size_tuples or not bw_tuples:
        raise ValueError("empty DSE space; widen grids or budgets")

    s3s, s3_of = _project(size_tuples, lambda t: t[:3])
    vs, v_of = _project(size_tuples, lambda t: t[3])
    b3s, b3_of = _project(bw_tuples, lambda t: t[:3])
    ws, w_of = _project(bw_tuples, lambda t: t[3])

    eng = _GridEngine(hw_base, nets)
    conv_mats, conv_pmats, conv_e = eng.conv_matrices(s3s, b3s,
                                                      workers=workers)
    simd_mats, simd_pmats, simd_e = eng.simd_matrices(vs, ws)
    if eng._gemm_union:
        # GEMMs share the conv separable axes (systolic-array buffers and
        # bandwidths), so fold them into the conv-side structures before
        # the grid composition — OUT-OF-PLACE: single-phase conv pmats
        # alias their totals matrix, so the originals must not mutate.
        # The phase dicts union disjoint "conv:*"/"gemm:*" keys and the
        # energy fields add per key; everything downstream (gridtorch,
        # the energy model, phase routing) is unchanged.
        gemm_mats, gemm_pmats, gemm_e = eng.gemm_matrices(s3s, b3s)
        conv_mats = {n: conv_mats[n] + gemm_mats[n] for n in conv_mats}
        conv_pmats = {n: {**conv_pmats[n], **gemm_pmats[n]}
                      for n in conv_pmats}
        conv_e = {n: {k: v + gemm_e[n][k] for k, v in conv_e[n].items()}
                  for n in conv_e}
    sizes_arr = np.array(size_tuples, dtype=np.int64)
    frontier_mult = 1.0 + FRONTIER_FRAC

    # On-device cycles sweeps reduce all networks in one batched
    # dispatch (the candidate-space projections are shared); general
    # objectives reduce per network inside the loop.
    dev_cycles = None
    if gridtorch is not None and type(obj) is Cycles:
        names = list(nets)
        dev_cycles = dict(zip(names, gridtorch.reduce_cycles_many(
            [conv_mats[n] for n in names], [simd_mats[n] for n in names],
            s3_of, b3_of, v_of, w_of, frontier_mult=frontier_mult,
            fused=(backend == "torch-fused"), device=device)))

    out: Dict[str, DSEResult] = {}
    for name in nets:
        energy = _EnergyFields(hw=hw_base, em=em, conv=conv_e[name],
                               simd=simd_e[name], s3_of=s3_of, v_of=v_of,
                               sizes_kb=sizes_arr)
        fmask = None             # flat within-FRONTIER_FRAC mask (device)
        report = None            # energy report grids, if already scored
        if type(obj) is Cycles:
            # Legacy fast path: the score IS the int64 cycle count.
            # (Exact-type check: a custom objective registered under the
            # "cycles" name still gets its score() called below.)
            scores = None
            if dev_cycles is not None:
                costs, bi, wi, fmask = dev_cycles[name]
                grid = DSEGrid(costs, size_tuples, bw_tuples)
                best = grid.point(bi)
                worst = grid.point(wi)
            else:
                costs = (conv_mats[name][np.ix_(s3_of, b3_of)]
                         + simd_mats[name][np.ix_(v_of, w_of)])
                grid = DSEGrid(costs, size_tuples, bw_tuples)
                flat = costs.ravel()
                # argmin/argmax return the first occurrence, matching the
                # legacy strict-inequality update order (size-outer,
                # bandwidth-inner).
                best = grid.point(int(flat.argmin()))
                worst = grid.point(int(flat.argmax()))
        elif gridtorch is not None:
            costs, scores, report, bi, wi, feasible, fmask = \
                gridtorch.reduce_scored(
                    conv_mats[name], simd_mats[name], s3_of, b3_of,
                    v_of, w_of, objective=obj,
                    energy_grids_fn=energy.grids,
                    frontier_mult=frontier_mult, device=device)
            if not feasible:
                raise ValueError(
                    f"objective {obj.name!r} marks every candidate "
                    f"infeasible for network {name!r}")
            grid = DSEGrid(costs, size_tuples, bw_tuples)
            best = grid.point(bi)
            worst = grid.point(wi)
        else:
            costs = (conv_mats[name][np.ix_(s3_of, b3_of)]
                     + simd_mats[name][np.ix_(v_of, w_of)])
            grid = DSEGrid(costs, size_tuples, bw_tuples)
            mb = MetricBatch(costs, lambda e=energy, c=costs: e.grids(c))
            scores = np.asarray(obj.score(mb), dtype=float)
            flat = scores.ravel()
            feasible = np.isfinite(flat)
            if not feasible.any():
                raise ValueError(
                    f"objective {obj.name!r} marks every candidate "
                    f"infeasible for network {name!r}")
            # mask BOTH extremes: a NaN score would otherwise poison
            # argmin (the worst side always masked; the best side is the
            # bugfix regression-tested in the JAX package's
            # test_gridax.py)
            best = grid.point(int(np.where(feasible, flat, np.inf)
                                  .argmin()))
            worst = grid.point(int(np.where(feasible, flat, -np.inf)
                                   .argmax()))
            # reuse the report the scoring pass already computed (None
            # if the objective never pulled energy)
            report = mb._report
        phases = _PhaseGrids(conv=conv_pmats[name], simd=simd_pmats[name],
                             s3_of=s3_of, b3_of=b3_of, v_of=v_of, w_of=w_of)
        # The device backends computed the FRONTIER_FRAC mask in the same
        # dispatch as best/worst — materialize it eagerly (identical to
        # the lazy host path: same promoted comparison, same grid order);
        # they also install the vectorized Pareto mask.
        frontier = None if fmask is None else \
            [grid.point(int(i)) for i in np.nonzero(fmask)[0]]
        out[name] = DSEResult(best=best, worst=worst, grid=grid,
                              phase_grids=phases, objective=obj.name,
                              grid_scores=scores, _energy=energy,
                              _frontier=frontier,
                              _energy_grids=report,
                              _pareto_mask_fn=None if gridtorch is None
                              else functools.partial(
                                  gridtorch.pareto_mask, device=device))
    return out


register_search_method("grid", _grid_search_many)


def _deprecated_search_study(hw_base: HardwareSpec,
                             sizes: Sequence[int], bws: Sequence[int],
                             tol: float, lower_bound: bool):
    import warnings
    warnings.warn(
        "search()/search_many() are deprecated; build a "
        "repro_torch.core.study.Study and call study.search(Workload(...), ...) "
        "— same results, plus objectives (energy/EDP/power caps) and "
        "parallel table builds", DeprecationWarning, stacklevel=3)
    from .study import Study
    return Study(hw_base, sizes=sizes, bws=bws, tol=tol,
                 lower_bound=lower_bound)


def search_many(hw_base: HardwareSpec, nets: Mapping[str, Sequence[Layer]],
                size_budget_kb: int, bw_budget: int,
                sizes: Sequence[int] = SIZES_KB, bws: Sequence[int] = BWS,
                tol: float = 0.15, lower_bound: bool = True,
                training: bool = False, method: str = "grid",
                refine=None) -> Dict[str, DSEResult]:
    """Deprecated: the legacy multi-network entry point, now a thin shim
    over ``repro_torch.core.study.Study`` (which adds first-class ``Workload``
    and ``Objective`` axes — energy, EDP, power caps — on the same
    engines).  Results are bit-identical to the ``Study`` path with the
    default cycles objective; see that module for the new API.

    ``training=True`` expands each network through the Table I training
    graph; ``method`` selects the front-end (``"grid"`` exhaustive,
    ``"refine"`` local search, with ``refine=RefineConfig(...)``);
    ``lower_bound=False`` drops the lower budget bound (Fig. 11 /
    Table X landscapes)."""
    from .study import Workload
    study = _deprecated_search_study(hw_base, sizes, bws, tol, lower_bound)
    return study.search_many(
        {name: Workload(net=tuple(net), training=training)
         for name, net in nets.items()},
        size_budget_kb, bw_budget, method=method, refine=refine)


def search(hw_base: HardwareSpec, net: Sequence[Layer],
           size_budget_kb: int, bw_budget: int,
           sizes: Sequence[int] = SIZES_KB, bws: Sequence[int] = BWS,
           tol: float = 0.15, lower_bound: bool = True,
           training: bool = False, method: str = "grid",
           refine=None) -> DSEResult:
    """Deprecated: single-network shim over ``Study``; see
    ``search_many``.  The full grid is kept as an array (``result.grid``)
    by the grid front-end, the evaluation archive by refine;
    ``result.points`` materializes only the within-15% frontier either
    way."""
    from .study import Workload
    study = _deprecated_search_study(hw_base, sizes, bws, tol, lower_bound)
    return study.search(Workload(net=tuple(net), training=training),
                        size_budget_kb, bw_budget,
                        method=method, refine=refine)


def phase_profile(hw: HardwareSpec, net: Sequence[Layer],
                  training: bool = False) -> PhaseBreakdown:
    """Phase-resolved cycles of one fixed configuration, evaluated through
    the batched cost tables (cycle-identical to the scalar simulator's
    'simdit' stall model, and sharing the process-lifetime table cache
    with any DSE sweep of the same shapes)."""
    if training:
        net = expand_training_graph(list(net))
    convs = [l for l in net if isinstance(l, ConvLayer)]
    gemms = [l for l in net if isinstance(l, GemmLayer)]
    simds = [l for l in net if isinstance(l, SimdLayer)]
    cycles: Dict[str, int] = {}
    if convs:
        per_phase = get_conv_table(hw, convs).phase_cycles_batch(
            [hw.bw_w], [hw.bw_i], [hw.bw_o])
        cycles.update({f"conv:{ph}": int(v[0])
                       for ph, v in per_phase.items()})
    if gemms:
        per_phase = get_gemm_table(hw, gemms).phase_cycles_batch(
            [hw.bw_w], [hw.bw_i], [hw.bw_o])
        for ph, v in per_phase.items():
            key = f"gemm:{ph}"
            cycles[key] = cycles.get(key, 0) + int(v[0])
    if simds:
        per_phase = get_simd_table(hw, simds).phase_cycles_batch([hw.bw_v])
        cycles.update({f"simd:{ph}": int(v[0])
                       for ph, v in per_phase.items()})
    return PhaseBreakdown.from_dict(cycles)


def frontier_shift(inference: DSEResult, training: DSEResult
                   ) -> Dict[str, float]:
    """How the optimal allocation moves when the workload switches from
    inference to training (the paper's qualitative Sec. VII-B discussion):
    the SIMD side's share of the best point's SRAM and bandwidth budgets,
    and the fraction of inference-frontier allocations that survive on the
    training frontier."""
    bi, bt = inference.best, training.best
    inf_allocs = {(p.sizes_kb, p.bws) for p in inference.points}
    trn_allocs = {(p.sizes_kb, p.bws) for p in training.points}
    overlap = (len(inf_allocs & trn_allocs) / len(inf_allocs)
               if inf_allocs else 0.0)
    return {
        "vmem_share_inf": bi.sizes_kb[3] / bi.total_size_kb,
        "vmem_share_trn": bt.sizes_kb[3] / bt.total_size_kb,
        "bw_v_share_inf": bi.bws[3] / bi.total_bw,
        "bw_v_share_trn": bt.bws[3] / bt.total_bw,
        "frontier_overlap": overlap,
    }


# ---------------------------------------------------------------------------
# Brute-force reference (the pre-tensorization scalar loop, retained for
# equivalence testing and the dse_scaling micro-benchmark)
# ---------------------------------------------------------------------------

@dataclass
class ReferenceResult:
    """Legacy result shape: every evaluated point materialized."""
    best: DSEPoint
    worst: DSEPoint
    points: List[DSEPoint] = field(default_factory=list)

    @property
    def improvement(self) -> float:
        return self.worst.cycles / self.best.cycles

    def within(self, frac: float) -> List[DSEPoint]:
        lim = self.best.cycles * (1 + frac)
        return [p for p in self.points if p.cycles <= lim]

    def economic_min_sram(self, frac: float = FRONTIER_FRAC) -> DSEPoint:
        return min(self.within(frac), key=lambda p: (p.total_size_kb, p.cycles))

    def economic_min_bw(self, frac: float = FRONTIER_FRAC) -> DSEPoint:
        return min(self.within(frac),
                   key=lambda p: (p.total_bw, p.total_size_kb, p.cycles))


class _Engine:
    """Scalar per-candidate evaluator (legacy path)."""

    def __init__(self, hw_base: HardwareSpec, net: Sequence[Layer]):
        self.hw = hw_base
        self.conv_layers = tuple(l for l in net if isinstance(l, ConvLayer))
        self.gemm_layers = tuple(l for l in net if isinstance(l, GemmLayer))
        self.simd_layers = tuple(l for l in net if isinstance(l, SimdLayer))

    @lru_cache(maxsize=None)
    def _conv_table(self, wbuf_kb: int, ibuf_kb: int, obuf_kb: int) -> ConvTable:
        hw = self.hw.replace(wbuf=wbuf_kb * KB, ibuf=ibuf_kb * KB,
                             obuf=obuf_kb * KB)
        return get_conv_table(hw, self.conv_layers)

    @lru_cache(maxsize=None)
    def _gemm_table(self, wbuf_kb: int, ibuf_kb: int, obuf_kb: int) -> GemmTable:
        hw = self.hw.replace(wbuf=wbuf_kb * KB, ibuf=ibuf_kb * KB,
                             obuf=obuf_kb * KB)
        return get_gemm_table(hw, self.gemm_layers)

    @lru_cache(maxsize=None)
    def _simd_table(self, vmem_kb: int) -> SimdTable:
        return get_simd_table(self.hw.replace(vmem=vmem_kb * KB),
                              self.simd_layers)

    @lru_cache(maxsize=None)
    def conv_cycles(self, wbuf_kb: int, ibuf_kb: int, obuf_kb: int,
                    bw_w: int, bw_i: int, bw_o: int) -> int:
        return self._conv_table(wbuf_kb, ibuf_kb, obuf_kb).cycles(bw_w, bw_i, bw_o)

    @lru_cache(maxsize=None)
    def gemm_cycles(self, wbuf_kb: int, ibuf_kb: int, obuf_kb: int,
                    bw_w: int, bw_i: int, bw_o: int) -> int:
        return self._gemm_table(wbuf_kb, ibuf_kb, obuf_kb).cycles(bw_w, bw_i, bw_o)

    @lru_cache(maxsize=None)
    def simd_cycles(self, vmem_kb: int, bw_v: int) -> int:
        return self._simd_table(vmem_kb).cycles(bw_v)

    def cycles(self, sz: Tuple[int, ...], bw: Tuple[int, ...]) -> int:
        total = self.simd_cycles(sz[3], bw[3])
        if self.conv_layers:
            total += self.conv_cycles(sz[0], sz[1], sz[2],
                                      bw[0], bw[1], bw[2])
        if self.gemm_layers:
            total += self.gemm_cycles(sz[0], sz[1], sz[2],
                                      bw[0], bw[1], bw[2])
        return total


def search_reference(hw_base: HardwareSpec, net: Sequence[Layer],
                     size_budget_kb: int, bw_budget: int,
                     sizes: Sequence[int] = SIZES_KB,
                     bws: Sequence[int] = BWS,
                     tol: float = 0.15, lower_bound: bool = True,
                     collect: bool = True) -> ReferenceResult:
    """The pre-tensorization brute force: a Python double loop with one
    scalar ``cycles()`` call and one ``DSEPoint`` per candidate.  With
    ``collect=False`` only the best/worst and the within-15% frontier are
    retained (second streaming pass)."""
    eng = _Engine(hw_base, net)
    lo_s = size_budget_kb * (1 - tol) if lower_bound else 0
    lo_b = bw_budget * (1 - tol) if lower_bound else 0
    size_tuples = _tuples(sizes, 4, lo_s, size_budget_kb * (1 + tol))
    bw_tuples = _tuples(bws, 4, lo_b, bw_budget * (1 + tol))
    if not size_tuples or not bw_tuples:
        raise ValueError("empty DSE space; widen grids or budgets")

    best: Optional[DSEPoint] = None
    worst: Optional[DSEPoint] = None
    points: List[DSEPoint] = []
    for sz in size_tuples:
        for bw in bw_tuples:
            cyc = eng.cycles(sz, bw)
            if best is None or cyc < best.cycles:
                best = DSEPoint(sz, bw, cyc)
            if worst is None or cyc > worst.cycles:
                worst = DSEPoint(sz, bw, cyc)
            if collect:
                points.append(DSEPoint(sz, bw, cyc))

    if not collect:
        lim = best.cycles * (1 + FRONTIER_FRAC)
        for sz in size_tuples:
            for bw in bw_tuples:
                cyc = eng.cycles(sz, bw)
                if cyc <= lim:
                    points.append(DSEPoint(sz, bw, cyc))
    return ReferenceResult(best=best, worst=worst, points=points)


# ---------------------------------------------------------------------------
# Sensitivity (Fig. 12)
# ---------------------------------------------------------------------------

def sensitivity(hw_opt: HardwareSpec, net: Sequence[Layer],
                sizes: Sequence[int] = SIZES_KB,
                bws: Sequence[int] = BWS) -> Dict[str, Dict[int, float]]:
    """Fig. 12: vary one parameter at a time around the optimal point;
    report cycles normalized to the optimal.  (Tilings are memoized keyed
    on sizes only, so the bandwidth sweeps re-derive nothing.)"""
    from .conv_model import simulate_conv
    from .gemm_model import simulate_gemm

    def sim(hw: HardwareSpec, l: Layer):
        if isinstance(l, ConvLayer):
            return simulate_conv(hw, l)
        if isinstance(l, GemmLayer):
            return simulate_gemm(hw, l)
        return simulate_simd(hw, l)

    def cost(hw: HardwareSpec) -> int:
        return sum(sim(hw, l).total_cycles for l in net)

    base = cost(hw_opt)
    out: Dict[str, Dict[int, float]] = {}
    for param, vals, unit in (
            ("wbuf", sizes, KB), ("ibuf", sizes, KB), ("obuf", sizes, KB),
            ("vmem", sizes, KB),
            ("bw_w", bws, 1), ("bw_i", bws, 1), ("bw_o", bws, 1),
            ("bw_v", bws, 1)):
        out[param] = {}
        for v in vals:
            hw = hw_opt.replace(**{param: v * unit})
            out[param][v] = cost(hw) / base
    return out

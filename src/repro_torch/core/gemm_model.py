"""Systolic-array GEMM performance model.

A GEMM out[m, n] = in[m, k] @ w[k, n] (+ bias[n]) maps onto the
weight-stationary array without im2col: k along the J rows, n along the
K columns, m streamed through.  Under that mapping a GEMM is the exact
specialization of the paper's Conv/FC model (Secs. IV-C, IV-D) at a
unit kernel window and unit spatial extents — ``fc(n=m, ic=k, oc=n)``
prices identically, which tests/test_gemm.py pins bit-exactly — so
every formula below is the conv formula with the vanished dims removed:

  * utilization comes from array-dim alignment: per-block compute is
    ``T_m * ceil(T_k/J) * ceil(T_n/K)`` cycles (+ PSO), so misaligned
    k/n dims idle rows/columns exactly like misaligned ic/oc,
  * DRAM access counts follow Eqs. 4/7/9-11 with the M/N/K multipliers,
  * SRAM access counts follow Table III,
  * DRAM stalls use the same Table IV tile-segment analysis (the
    occurrence-count partition specializes to the M/N/K loop nest).

``GemmLayer.count`` repeats the identical GEMM (per-head / per-expert
instances): the scalar helpers model ONE instance and ``simulate_gemm``
scales the totals; the batched table path folds the factor into the
occurrence counts and energy tensors directly (stalls are linear in the
occurrence counts, so both routes agree exactly).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np

from .conv_model import PerfStats
from .hardware import HardwareSpec
from .layers import GemmLayer
from .tiling import GemmTiling, ceil_div, make_gemm_tiling


@dataclass(frozen=True)
class GemmMultipliers:
    """Outer (m_*) and inner (r_*) loop multipliers of the M/N/K nest."""
    m_m: int; m_k: int; m_n: int
    r_k: int; r_n: int

    @property
    def m_outer(self) -> int:
        return self.m_m * self.m_k * self.m_n

    @property
    def m_w_tile(self) -> int:                 # weight-block reload count
        return self.m_k * self.m_n

    @property
    def m_accum(self) -> int:                  # psum accumulation depth
        return self.m_k


def gemm_multipliers(layer: GemmLayer, t: GemmTiling) -> GemmMultipliers:
    return GemmMultipliers(
        m_m=ceil_div(layer.m, t.T_m), m_k=ceil_div(layer.k, t.T_k),
        m_n=ceil_div(layer.n, t.T_n),
        r_k=ceil_div(t.T_k, t.t_k), r_n=ceil_div(t.T_n, t.t_n))


# ---------------------------------------------------------------------------
# DRAM / SRAM accesses (one GEMM instance)
# ---------------------------------------------------------------------------

def gemm_dram_bits(hw: HardwareSpec, layer: GemmLayer, t: GemmTiling,
                   m: GemmMultipliers) -> Dict[str, int]:
    a_dw = t.weight_tile_elems() * m.m_w_tile * hw.b_w
    a_di = t.input_tile_elems() * m.m_outer * hw.b_i
    m_p = m.m_m * m.m_n * (2 * m.m_accum - 1)
    a_dp = t.psum_tile_elems() * m_p * hw.b_p
    a_db = t.T_n * m.m_n * hw.b_b if layer.has_bias else 0
    return {"weight": a_dw, "ifmap": a_di, "psum": a_dp, "bias": a_db}


def gemm_sram_bits(hw: HardwareSpec, layer: GemmLayer, t: GemmTiling,
                   m: GemmMultipliers) -> Dict[str, int]:
    m_inner = t.T_m * m.r_k * m.r_n
    iters = m_inner * m.m_outer
    out_elems = layer.m * layer.n
    a_sw = t.t_k * t.t_n * iters * hw.b_w
    a_si = t.t_k * iters * hw.b_i
    a_sp = (t.t_n * 2 * iters - out_elems) * hw.b_p
    a_sb = out_elems * hw.b_b if layer.has_bias else 0
    return {"wbuf": a_sw, "ibuf": a_si, "obuf": a_sp, "bbuf": a_sb}


# ---------------------------------------------------------------------------
# Cycle counts
# ---------------------------------------------------------------------------

def gemm_tile_compute_cycles(hw: HardwareSpec, t: GemmTiling) -> int:
    """Per-block compute: the array-dim-alignment utilization model."""
    return t.T_m * ceil_div(t.T_k, hw.J) * ceil_div(t.T_n, hw.K)


def gemm_compute_cycles(hw: HardwareSpec, layer: GemmLayer, t: GemmTiling,
                        m: GemmMultipliers) -> int:
    return (gemm_tile_compute_cycles(hw, t) + hw.pso_sa) * m.m_outer


@dataclass(frozen=True)
class GemmSegmentQuantities:
    """Bandwidth-independent per-block stall-model quantities (one GEMM
    instance) — the GEMM twin of ``ConvSegmentQuantities``."""
    c_tile: int
    o1: int; o2: int; o4: int; o5: int
    w_bits: int
    wb_bits: int
    i_bits: int
    ps_bits: int
    pls_bits: int


def gemm_segment_quantities(hw: HardwareSpec, layer: GemmLayer,
                            t: GemmTiling, m: GemmMultipliers
                            ) -> GemmSegmentQuantities:
    o5 = m.m_n
    o4 = m.m_w_tile - m.m_n
    o1 = m.m_n * (m.m_m - 1)
    o2 = (m.m_outer - m.m_m * m.m_n) - o4
    assert o1 >= 0 and o2 >= 0 and o4 >= 0
    assert o1 + o2 + o4 + o5 == m.m_outer

    w_bits = t.weight_tile_elems() * hw.b_w
    b_bits = t.T_n * hw.b_b if layer.has_bias else 0
    p_bits = t.psum_tile_elems() * hw.b_p
    return GemmSegmentQuantities(
        c_tile=gemm_tile_compute_cycles(hw, t) + hw.pso_sa,
        o1=o1, o2=o2, o4=o4, o5=o5,
        w_bits=w_bits, wb_bits=w_bits + b_bits,
        i_bits=t.input_tile_elems() * hw.b_i,
        ps_bits=p_bits, pls_bits=2 * p_bits)


def gemm_quantities_batch(hw: HardwareSpec, layer: GemmLayer,
                          tilings: Sequence[GemmTiling]
                          ) -> Dict[str, np.ndarray]:
    """Vectorized cost-table quantities for ONE GEMM layer across many
    tilings, same keys as ``conv_quantities_batch``.  ``layer.count`` is
    folded into the occurrence counts, busy cycles, and DRAM/SRAM energy
    tensors (all linear), leaving the per-block volumes untouched.

    ``tilings`` is either a sequence of ``GemmTiling``s or the
    struct-of-arrays 5-tuple ``tiling._derive_gemm_tiling_arrays``
    returns (the zero-materialization fast path)."""
    if isinstance(tilings, tuple) and len(tilings) == 5 \
            and isinstance(tilings[0], np.ndarray):
        T_m, T_k, T_n, t_k, t_n = tilings
    else:
        f = np.array([[t.T_m, t.T_k, t.T_n, t.t_k, t.t_n] for t in tilings],
                     dtype=np.int64).T
        T_m, T_k, T_n, t_k, t_n = f

    def cd(a, b):
        return -(-a // b)

    cnt = layer.count
    m_m = cd(layer.m, T_m); m_k = cd(layer.k, T_k); m_n = cd(layer.n, T_n)
    r_k = cd(T_k, t_k); r_n = cd(T_n, t_n)
    m_w_tile = m_k * m_n
    m_outer = m_m * m_w_tile
    m_inner = T_m * r_k * r_n

    c_tile = T_m * cd(T_k, hw.J) * cd(T_n, hw.K) + hw.pso_sa
    o5 = m_n
    o4 = m_w_tile - m_n
    o1 = m_n * (m_m - 1)
    o2 = (m_outer - m_m * m_n) - o4
    assert (o1 >= 0).all() and (o2 >= 0).all() and (o4 >= 0).all()
    assert (o1 + o2 + o4 + o5 == m_outer).all()

    w_elems = T_k * T_n
    i_elems = T_m * T_k
    p_elems = T_m * T_n
    w_bits = w_elems * hw.b_w
    b_bits = T_n * hw.b_b if layer.has_bias else 0
    ps_bits = p_elems * hw.b_p

    m_p = m_m * m_n * (2 * m_k - 1)
    dram = (w_elems * m_w_tile * hw.b_w
            + i_elems * m_outer * hw.b_i
            + p_elems * m_p * hw.b_p
            + (T_n * m_n * hw.b_b if layer.has_bias else 0)) * cnt

    iters = m_inner * m_outer
    out_elems = layer.m * layer.n
    sram = {"wbuf": t_k * t_n * iters * hw.b_w * cnt,
            "ibuf": t_k * iters * hw.b_i * cnt,
            "obuf": (t_n * 2 * iters - out_elems) * hw.b_p * cnt,
            "bbuf": (np.full(len(T_n), out_elems * hw.b_b * cnt,
                             dtype=np.int64)
                     if layer.has_bias
                     else np.zeros(len(T_n), dtype=np.int64))}
    return {"c_tile": c_tile, "o1": o1 * cnt, "o2": o2 * cnt,
            "o4": o4 * cnt, "o5": o5 * cnt,
            "w_bits": w_bits, "wb_bits": w_bits + b_bits,
            "i_bits": i_elems * hw.b_i,
            "ps_bits": ps_bits, "pls_bits": 2 * ps_bits,
            "busy": c_tile * m_outer * cnt, "dram": dram, "sram": sram}


def gemm_stall_cycles(hw: HardwareSpec, layer: GemmLayer, t: GemmTiling,
                      m: GemmMultipliers) -> int:
    """Table IV tile-segment DRAM stall model, one GEMM instance."""
    q = gemm_segment_quantities(hw, layer, t, m)
    t_w = ceil_div(q.w_bits, hw.bw_w)
    t_wb = ceil_div(q.wb_bits, hw.bw_w)
    t_i = ceil_div(q.i_bits, hw.bw_i)
    t_ps = ceil_div(q.ps_bits, hw.bw_o)
    t_pls = ceil_div(q.pls_bits, hw.bw_o)

    seg1 = max(q.c_tile, t_i, t_ps)
    seg2 = max(q.c_tile, t_i, t_pls)
    seg4 = max(q.c_tile, t_w, t_i, t_pls)
    seg5 = max(q.c_tile, t_wb, t_i, t_ps)

    total_time = (q.o1 * seg1 + q.o2 * seg2
                  + q.o4 * seg4 + q.o5 * seg5)
    compute = q.c_tile * m.m_outer
    return max(0, total_time - compute)


# ---------------------------------------------------------------------------
# Top-level per-layer entry point
# ---------------------------------------------------------------------------

def simulate_gemm(hw: HardwareSpec, layer: GemmLayer,
                  t: GemmTiling | None = None,
                  stall_model: str = "simdit") -> PerfStats:
    """Full GEMM model (count-scaled totals).  ``stall_model`` mirrors
    ``simulate_conv``'s {simdit, no_stall, simplified}."""
    if t is None:
        t = make_gemm_tiling(hw, layer)
    m = gemm_multipliers(layer, t)
    dram = gemm_dram_bits(hw, layer, t, m)
    sram = gemm_sram_bits(hw, layer, t, m)
    compute = gemm_compute_cycles(hw, layer, t, m)

    if stall_model == "no_stall":
        stall = 0
    elif stall_model == "simplified":
        t_wb = ceil_div(dram["weight"] + dram["bias"], hw.bw_w)
        t_i = ceil_div(dram["ifmap"], hw.bw_i)
        t_p = ceil_div(dram["psum"], hw.bw_o)
        stall = max(0, max(compute, t_wb, t_i, t_p) - compute)
    else:
        stall = gemm_stall_cycles(hw, layer, t, m)

    cnt = layer.count
    ops = {"mac": layer.macs}                 # macs is already count-scaled
    if layer.has_bias:
        ops["add"] = layer.out_elems * cnt
    return PerfStats(engine="sa",
                     compute_cycles=compute * cnt, stall_cycles=stall * cnt,
                     dram_bits={k: v * cnt for k, v in dram.items()},
                     sram_bits={k: v * cnt for k, v in sram.items()},
                     ops=ops)

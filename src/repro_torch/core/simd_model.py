"""SIMD-array (non-Conv) performance model — paper Secs. IV-E, V-C, App. A.

One generic engine evaluates every non-Conv layer expressed as
``SimdPart``s over an (h, w, n, c) iteration space:

  DRAM   : each 4D tensor tile is loaded/stored once per (h,w,n,c) outer
           iteration; each 1D tensor once per c iteration       (Eqs. 19-20, 34)
  SRAM   : 3 VMem accesses (2 reads + 1 write) per arithmetic op (Eqs. 35-36)
  compute: K ALUs in parallel, ceil(T_c/K) lane groups, latency
           sum(lambda_op); + PSO_SIMD per tile                  (Eqs. 21-22, 37-39)
  stalls : single-buffered VMem -> sequential load/store around each tile
           computation                                          (Eqs. 23, 40)
"""
from __future__ import annotations

import math
from typing import Dict

from .conv_model import PerfStats
from .hardware import HardwareSpec
from .layers import SimdLayer, SimdPart
from .tiling import SimdTiling, ceil_div, make_simd_tiling


def simd_part_tile_bits(hw: HardwareSpec, part: SimdPart,
                        t: SimdTiling) -> tuple[int, int]:
    """Per-tile DRAM traffic of one part: (bits per 4D (h,w,n,c) tile,
    bits per 1D per-c-tile load/store).  Bandwidth-independent — shared by
    the per-layer stall model and the DSE cost tables."""
    v4 = t.T_h * t.T_w * t.T_n * t.T_c
    bits_4d_per_tile = 0
    for ref in part.tensors:
        if ref.rank == "4d":
            vol = int(math.ceil(v4 * ref.scale))
            bits_4d_per_tile += vol * (hw.b_in if ref.io == "in" else hw.b_out)
    bits_1d_per_ctile = sum(
        t.T_c * (hw.b_in if ref.io == "in" else hw.b_out)
        for ref in part.tensors if ref.rank == "1d")
    return bits_4d_per_tile, bits_1d_per_ctile


def _part_stats(hw: HardwareSpec, layer: SimdLayer, part: SimdPart,
                t: SimdTiling) -> PerfStats:
    m_h = ceil_div(layer.h, t.T_h)
    m_w = ceil_div(layer.w, t.T_w)
    m_n = ceil_div(layer.n, t.T_n)
    m_c = ceil_div(layer.c, t.T_c)
    m_hwn = m_h * m_w * m_n

    v4 = t.T_h * t.T_w * t.T_n * t.T_c
    v1 = t.T_c

    # ---- DRAM ------------------------------------------------------------
    bits_4d_per_tile, bits_1d_per_ctile = simd_part_tile_bits(hw, part, t)
    dram_bits = (bits_4d_per_tile * m_hwn + bits_1d_per_ctile) * m_c

    # ---- op counts ---------------------------------------------------------
    ops: Dict[str, int] = {}
    n4 = v4 * m_hwn * m_c          # ceiling-padded element count
    n1 = v1 * m_c
    for op in part.ops4d:
        ops[op] = ops.get(op, 0) + n4
    for op in part.ops1d:
        ops[op] = ops.get(op, 0) + n1
    op_count = len(part.ops4d) * n4 + len(part.ops1d) * n1

    # ---- SRAM: 3 accesses (2r + 1w) per arithmetic op (Eq. 36) ------------
    sram_bits = op_count * 3 * hw.b_in

    # ---- compute cycles ----------------------------------------------------
    lam4 = sum(hw.lam(op) for op in part.ops4d)
    lam1 = sum(hw.lam(op) for op in part.ops1d)
    lanes = ceil_div(t.T_c, hw.K)
    c_tile4 = t.T_h * t.T_w * t.T_n * lanes * lam4           # Eq. 21 / Eq. 38
    c_tile1 = lanes * lam1                                   # Eq. 37
    compute = 0
    if lam4:
        compute += (c_tile4 + hw.pso_simd) * m_hwn * m_c     # Eq. 22 / Eq. 39
    if lam1:
        compute += c_tile1 * m_c

    # ---- stalls (single buffered; Eq. 23 / Eq. 40) -------------------------
    stall = (ceil_div(bits_4d_per_tile, hw.bw_v) * m_hwn
             + (ceil_div(bits_1d_per_ctile, hw.bw_v) if bits_1d_per_ctile else 0)
             ) * m_c

    return PerfStats(engine="simd", compute_cycles=compute, stall_cycles=stall,
                     dram_bits={"vmem": dram_bits},
                     sram_bits={"vmem": sram_bits}, ops=ops)


def simulate_simd(hw: HardwareSpec, layer: SimdLayer,
                  t: SimdTiling | None = None,
                  stall_model: str = "simdit") -> PerfStats:
    if t is None:
        t = make_simd_tiling(hw, layer)
    out = PerfStats(engine="simd")
    for part in layer.parts:
        out = out.merged(_part_stats(hw, layer, part, t))
    out.engine = "simd"
    if stall_model == "no_stall":
        out.stall_cycles = 0
    elif stall_model == "simplified":
        t_v = ceil_div(out.dram_total_bits, hw.bw_v)
        out.stall_cycles = max(0, max(out.compute_cycles, t_v) - out.compute_cycles)
    return out

"""Systolic-array (Conv/FC) performance model — paper Sections IV-C, IV-D.

Implements, with ceiling-corrected multipliers (paper footnote 1):
  * DRAM access counts  A_Dw (Eq. 4), A_Di (Eq. 7), A_Dp (Eqs. 9-10),
    A_Db (Eq. 11)                                     [bits]
  * SRAM access counts  (Table III)                   [bits]
  * compute cycles      (Eqs. 15-16, PSO_SA = (J-1)+(K-1))
  * DRAM stall cycles   under double buffering via the exhaustive 4-valid-
    case tile-segment analysis (Table IV, Fig. 6, Eqs. 17-18).

Also provides the two degraded baselines of Fig. 5 ("No-Stall" and
"Simplified") for the accuracy comparison benchmark.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Sequence

import numpy as np

from .hardware import HardwareSpec
from .layers import ConvLayer
from .tiling import ConvTiling, ceil_div, make_conv_tiling


@dataclass
class PerfStats:
    """Per-layer performance statistics (the SimDIT output interface)."""
    engine: str = "sa"                       # 'sa' | 'simd'
    compute_cycles: int = 0
    stall_cycles: int = 0
    dram_bits: Dict[str, int] = field(default_factory=dict)   # by stream
    sram_bits: Dict[str, int] = field(default_factory=dict)   # by buffer
    ops: Dict[str, int] = field(default_factory=dict)         # arithmetic op counts

    @property
    def total_cycles(self) -> int:
        return self.compute_cycles + self.stall_cycles

    @property
    def dram_total_bits(self) -> int:
        return sum(self.dram_bits.values())

    @property
    def sram_total_bits(self) -> int:
        return sum(self.sram_bits.values())

    def merged(self, other: "PerfStats") -> "PerfStats":
        out = PerfStats(engine=self.engine,
                        compute_cycles=self.compute_cycles + other.compute_cycles,
                        stall_cycles=self.stall_cycles + other.stall_cycles)
        for src, dst in ((self.dram_bits, out.dram_bits),
                         (other.dram_bits, out.dram_bits)):
            for k, v in src.items():
                dst[k] = dst.get(k, 0) + v
        for src, dst in ((self.sram_bits, out.sram_bits),
                         (other.sram_bits, out.sram_bits)):
            for k, v in src.items():
                dst[k] = dst.get(k, 0) + v
        for src in (self.ops, other.ops):
            for k, v in src.items():
                out.ops[k] = out.ops.get(k, 0) + v
        return out


@dataclass(frozen=True)
class ConvMultipliers:
    """Outer (m_*) and inner (r_*) loop multipliers (Eqs. 1, 12)."""
    m_oh: int; m_ow: int; m_n: int; m_kh: int; m_kw: int; m_ic: int; m_oc: int
    r_oh: int; r_ow: int; r_n: int; r_kh: int; r_kw: int; r_ic: int; r_oc: int

    @property
    def m_outer(self) -> int:                      # Eq. 14
        return (self.m_oh * self.m_ow * self.m_n * self.m_kh * self.m_kw
                * self.m_ic * self.m_oc)

    @property
    def m_w_tile(self) -> int:                     # Eq. 3
        return self.m_kh * self.m_kw * self.m_ic * self.m_oc

    @property
    def m_spatial(self) -> int:                    # m_oh * m_ow * m_n
        return self.m_oh * self.m_ow * self.m_n

    @property
    def m_accum(self) -> int:                      # m_kh * m_kw * m_ic
        return self.m_kh * self.m_kw * self.m_ic

    @property
    def m_inner(self) -> int:                      # Eq. 13
        return (self.r_oh * self.r_ow * self.r_n * self.r_kh * self.r_kw
                * self.r_ic * self.r_oc)


def conv_multipliers(layer: ConvLayer, t: ConvTiling) -> ConvMultipliers:
    return ConvMultipliers(
        m_oh=ceil_div(layer.oh, t.T_oh), m_ow=ceil_div(layer.ow, t.T_ow),
        m_n=ceil_div(layer.n, t.T_n), m_kh=ceil_div(layer.kh, t.T_kh),
        m_kw=ceil_div(layer.kw, t.T_kw), m_ic=ceil_div(layer.ic, t.T_ic),
        m_oc=ceil_div(layer.oc, t.T_oc),
        r_oh=t.T_oh, r_ow=t.T_ow, r_n=t.T_n, r_kh=t.T_kh, r_kw=t.T_kw,
        r_ic=ceil_div(t.T_ic, t.t_ic), r_oc=ceil_div(t.T_oc, t.t_oc))


# ---------------------------------------------------------------------------
# DRAM accesses (Sec. IV-C)
# ---------------------------------------------------------------------------

def conv_dram_bits(hw: HardwareSpec, layer: ConvLayer, t: ConvTiling,
                   m: ConvMultipliers) -> Dict[str, int]:
    v_w = t.weight_tile_elems()                               # Eq. 2
    a_dw = v_w * m.m_w_tile * hw.b_w                          # Eq. 4

    v_i = t.ifmap_tile_elems(layer.s)                         # Eq. 5
    a_di = v_i * m.m_outer * hw.b_i                           # Eqs. 6-7

    v_p = t.psum_tile_elems()                                 # Eq. 8
    m_p = m.m_spatial * m.m_oc * (2 * m.m_accum - 1)          # Eq. 9
    a_dp = v_p * m_p * hw.b_p                                 # Eq. 10

    a_db = t.T_oc * m.m_oc * hw.b_b if layer.has_bias else 0  # Eq. 11
    return {"weight": a_dw, "ifmap": a_di, "psum": a_dp, "bias": a_db}


# ---------------------------------------------------------------------------
# SRAM accesses (Table III)
# ---------------------------------------------------------------------------

def conv_sram_bits(hw: HardwareSpec, layer: ConvLayer, t: ConvTiling,
                   m: ConvMultipliers) -> Dict[str, int]:
    iters = m.m_inner * m.m_outer
    v_w_i = t.T_kh * t.T_kw * t.t_ic * t.t_oc // (t.T_kh * t.T_kw)  # inner tile
    # Inner tiles have t_phi = 1 on every dim except ic/oc (Fig. 4):
    v_w_inner = t.t_ic * t.t_oc
    v_i_inner = t.t_ic
    v_p_inner = t.t_oc
    ofmap_elems = layer.ofmap_elems

    a_sw = v_w_inner * iters * hw.b_w
    a_si = v_i_inner * iters * hw.b_i
    a_sp = (v_p_inner * 2 * iters - ofmap_elems) * hw.b_p
    a_sb = ofmap_elems * hw.b_b if layer.has_bias else 0
    return {"wbuf": a_sw, "ibuf": a_si, "obuf": a_sp, "bbuf": a_sb}


# ---------------------------------------------------------------------------
# Cycle counts (Sec. IV-D)
# ---------------------------------------------------------------------------

def conv_tile_compute_cycles(hw: HardwareSpec, t: ConvTiling) -> int:
    """Eq. 15."""
    return (t.T_oh * t.T_ow * t.T_n * t.T_kh * t.T_kw
            * ceil_div(t.T_ic, hw.J) * ceil_div(t.T_oc, hw.K))


def conv_compute_cycles(hw: HardwareSpec, layer: ConvLayer, t: ConvTiling,
                        m: ConvMultipliers) -> int:
    """Eq. 16 (includes per-tile pipeline setup overhead)."""
    return (conv_tile_compute_cycles(hw, t) + hw.pso_sa) * m.m_outer


@dataclass(frozen=True)
class ConvSegmentQuantities:
    """Bandwidth-independent per-tile quantities of the Table IV / Eq. 18
    tile-segment stall model: per-tile compute cycles, the four valid-case
    occurrence counts, and the per-stream DRAM bit volumes.  They depend
    only on the tiling (i.e. buffer *sizes*), so a bandwidth sweep over a
    fixed size configuration reuses one instance (the property the
    tensorized DSE in ``core.dse`` exploits)."""
    c_tile: int                               # compute cycles/tile incl. PSO
    o1: int; o2: int; o4: int; o5: int        # case occurrence counts
    w_bits: int                               # weight tile
    wb_bits: int                              # weight + bias tile
    i_bits: int                               # ifmap tile
    ps_bits: int                              # psum store only
    pls_bits: int                             # psum load + store (2x)


def conv_segment_quantities(hw: HardwareSpec, layer: ConvLayer,
                            t: ConvTiling, m: ConvMultipliers
                            ) -> ConvSegmentQuantities:
    """Occurrence counts (Sec. IV-D, Case-4 derivation generalized) and
    per-stream tile volumes shared by ``conv_stall_cycles`` and the DSE
    cost tables."""
    o5 = m.m_oc
    o4 = m.m_w_tile - m.m_oc                                    # Eq. 17
    o1 = m.m_oc * (m.m_spatial - 1)
    o2 = (m.m_outer - m.m_spatial * m.m_oc) - o4
    assert o1 >= 0 and o2 >= 0 and o4 >= 0
    assert o1 + o2 + o4 + o5 == m.m_outer

    w_bits = t.weight_tile_elems() * hw.b_w
    b_bits = t.T_oc * hw.b_b if layer.has_bias else 0
    p_bits = t.psum_tile_elems() * hw.b_p
    return ConvSegmentQuantities(
        c_tile=conv_tile_compute_cycles(hw, t) + hw.pso_sa,
        o1=o1, o2=o2, o4=o4, o5=o5,
        w_bits=w_bits, wb_bits=w_bits + b_bits,
        i_bits=t.ifmap_tile_elems(layer.s) * hw.b_i,
        ps_bits=p_bits, pls_bits=2 * p_bits)


def conv_quantities_batch(hw: HardwareSpec, layer: ConvLayer,
                          tilings: Sequence[ConvTiling]
                          ) -> Dict[str, np.ndarray]:
    """Vectorized per-candidate cost-table quantities for ONE layer across
    many tilings (one per buffer-size candidate): the
    ``ConvSegmentQuantities`` fields plus the busy/DRAM/SRAM energy
    tensors a ``ConvTable`` column carries.  Bit-identical per candidate
    to the scalar ``conv_segment_quantities`` / ``conv_dram_bits`` /
    ``conv_sram_bits`` / ``conv_tile_compute_cycles`` composition (same
    integer arithmetic, evaluated on the candidate axis), which is what
    lets ``dse.batch_build_conv_tables`` assemble whole table lattices
    without a per-(size, layer) Python walk.

    ``tilings`` is either a sequence of ``ConvTiling``s or the
    struct-of-arrays 9-tuple ``tiling._derive_conv_tiling_arrays``
    returns (the zero-materialization fast path)."""
    if isinstance(tilings, tuple) and len(tilings) == 9 \
            and isinstance(tilings[0], np.ndarray):
        T_oh, T_ow, T_n, T_kh, T_kw, T_ic, T_oc, t_ic, t_oc = tilings
    else:
        f = np.array([[t.T_oh, t.T_ow, t.T_n, t.T_kh, t.T_kw, t.T_ic,
                       t.T_oc, t.t_ic, t.t_oc] for t in tilings],
                     dtype=np.int64).T
        T_oh, T_ow, T_n, T_kh, T_kw, T_ic, T_oc, t_ic, t_oc = f

    def cd(a, b):
        return -(-a // b)

    m_oh = cd(layer.oh, T_oh); m_ow = cd(layer.ow, T_ow)
    m_n = cd(layer.n, T_n); m_kh = cd(layer.kh, T_kh)
    m_kw = cd(layer.kw, T_kw); m_ic = cd(layer.ic, T_ic)
    m_oc = cd(layer.oc, T_oc)
    r_ic = cd(T_ic, t_ic); r_oc = cd(T_oc, t_oc)
    m_w_tile = m_kh * m_kw * m_ic * m_oc
    m_spatial = m_oh * m_ow * m_n
    m_accum = m_kh * m_kw * m_ic
    m_outer = m_spatial * m_w_tile
    m_inner = T_oh * T_ow * T_n * T_kh * T_kw * r_ic * r_oc

    c_tile = (T_oh * T_ow * T_n * T_kh * T_kw
              * cd(T_ic, hw.J) * cd(T_oc, hw.K)) + hw.pso_sa
    o5 = m_oc
    o4 = m_w_tile - m_oc                                        # Eq. 17
    o1 = m_oc * (m_spatial - 1)
    o2 = (m_outer - m_spatial * m_oc) - o4
    assert (o1 >= 0).all() and (o2 >= 0).all() and (o4 >= 0).all()
    assert (o1 + o2 + o4 + o5 == m_outer).all()

    w_elems = T_kh * T_kw * T_ic * T_oc                         # Eq. 2
    ih = (T_oh - 1) * layer.s + T_kh
    iw = (T_ow - 1) * layer.s + T_kw
    i_elems = ih * iw * T_n * T_ic                              # Eq. 5
    p_elems = T_oh * T_ow * T_n * T_oc                          # Eq. 8
    w_bits = w_elems * hw.b_w
    b_bits = T_oc * hw.b_b if layer.has_bias else 0
    ps_bits = p_elems * hw.b_p

    m_p = m_spatial * m_oc * (2 * m_accum - 1)                  # Eq. 9
    dram = (w_elems * m_w_tile * hw.b_w                         # Eq. 4
            + i_elems * m_outer * hw.b_i                        # Eqs. 6-7
            + p_elems * m_p * hw.b_p                            # Eq. 10
            + (T_oc * m_oc * hw.b_b if layer.has_bias else 0))  # Eq. 11

    iters = m_inner * m_outer                                   # Table III
    ofmap_elems = layer.ofmap_elems
    sram = {"wbuf": t_ic * t_oc * iters * hw.b_w,
            "ibuf": t_ic * iters * hw.b_i,
            "obuf": (t_oc * 2 * iters - ofmap_elems) * hw.b_p,
            "bbuf": (np.full(len(T_oc), ofmap_elems * hw.b_b, dtype=np.int64)
                     if layer.has_bias
                     else np.zeros(len(T_oc), dtype=np.int64))}
    return {"c_tile": c_tile, "o1": o1, "o2": o2, "o4": o4, "o5": o5,
            "w_bits": w_bits, "wb_bits": w_bits + b_bits,
            "i_bits": i_elems * hw.b_i,
            "ps_bits": ps_bits, "pls_bits": 2 * ps_bits,
            "busy": c_tile * m_outer, "dram": dram, "sram": sram}


def conv_stall_cycles(hw: HardwareSpec, layer: ConvLayer, t: ConvTiling,
                      m: ConvMultipliers) -> int:
    """Tile-segment DRAM stall model (Table IV; Fig. 6; Eqs. 17-18).

    Valid cases (weight+bias load / weight load / psum load):
      Case-1: 0/0/0 -- weight reused, first accumulation step already done
      Case-2: 0/0/1 -- weight reused, psum accumulation continues
      Case-4: 0/1/1 -- new weight tile mid-accumulation
      Case-5: 1/0/0 -- new weight+bias tile at an oc-loop boundary
    Every case also performs the always-on ifmap load and psum/ofmap store.
    Per-tile segment time = max over the parallel DRAM interfaces and the
    compute (Fig. 6(b)); psum load & store share the OBuf interface and are
    serialized (the 2x term of Eq. 18).
    """
    q = conv_segment_quantities(hw, layer, t, m)
    t_w = ceil_div(q.w_bits, hw.bw_w)
    t_wb = ceil_div(q.wb_bits, hw.bw_w)
    t_i = ceil_div(q.i_bits, hw.bw_i)
    t_ps = ceil_div(q.ps_bits, hw.bw_o)        # store only
    t_pls = ceil_div(q.pls_bits, hw.bw_o)      # load + store, shared interface

    seg1 = max(q.c_tile, t_i, t_ps)
    seg2 = max(q.c_tile, t_i, t_pls)
    seg4 = max(q.c_tile, t_w, t_i, t_pls)                       # Eq. 18
    seg5 = max(q.c_tile, t_wb, t_i, t_ps)

    total_time = (q.o1 * seg1 + q.o2 * seg2
                  + q.o4 * seg4 + q.o5 * seg5)
    compute = q.c_tile * m.m_outer
    return max(0, total_time - compute)


# ---------------------------------------------------------------------------
# Top-level per-layer entry points
# ---------------------------------------------------------------------------

def simulate_conv(hw: HardwareSpec, layer: ConvLayer,
                  t: ConvTiling | None = None,
                  stall_model: str = "simdit") -> PerfStats:
    """Full SimDIT Conv model. ``stall_model`` in {simdit, no_stall,
    simplified} — the latter two reproduce the Fig. 5 baselines."""
    if t is None:
        t = make_conv_tiling(hw, layer)
    m = conv_multipliers(layer, t)
    dram = conv_dram_bits(hw, layer, t, m)
    sram = conv_sram_bits(hw, layer, t, m)
    compute = conv_compute_cycles(hw, layer, t, m)

    if stall_model == "no_stall":
        stall = 0
    elif stall_model == "simplified":
        # max of isolated totals across the four parallel components
        t_wb = ceil_div(dram["weight"] + dram["bias"], hw.bw_w)
        t_i = ceil_div(dram["ifmap"], hw.bw_i)
        t_p = ceil_div(dram["psum"], hw.bw_o)
        stall = max(0, max(compute, t_wb, t_i, t_p) - compute)
    else:
        stall = conv_stall_cycles(hw, layer, t, m)

    macs = layer.macs
    ops = {"mac": macs}
    if layer.has_bias:
        ops["add"] = layer.ofmap_elems
    return PerfStats(engine="sa", compute_cycles=compute, stall_cycles=stall,
                     dram_bits=dram, sram_bits=sram, ops=ops)

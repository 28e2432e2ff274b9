"""Energy / power computation — paper Sec. VI.

E_total = E_SA + E_SIMD + E_S + E_D                         (Eq. 29)
E_SA    = (C_SA * P_SA_dyn + L_total * P_SA_leak) * T_clk    (Eq. 30)
E_S     = sum_buff A_S_buff * e_buff ;  E_D = A_D * e_D      (Eq. 31)
P_avg   = E_total / (L_total * T_clk)                        (Eq. 32)

Constants: the paper uses proprietary post-SP&R data (commercial 12nm flow)
and a commercial memory compiler; those are not published. We substitute
openly documented values, recorded here so every number is reproducible:
  * e_D = 3.9 pJ/bit  -- HBM2 access energy (O'Connor et al., MICRO'17 [21])
  * SRAM read/write energy: CACTI-style capacity fit at ~14/12nm,
    e_sram(S) = 0.035 * (S_kB / 32)^0.25 pJ/bit  (anchors near ~0.03-0.08
    pJ/bit for 32kB-2MB banks reported for 14nm compilers)
  * MAC dynamic power: 16b ~0.35 mW @1GHz, 8b ~0.12 mW (DNN-accel surveys);
    SIMD 32b ALU+ctrl ~0.6 mW; leakage = 8% of array dynamic.
  * T_clk = 1 ns (1 GHz, the GeneSys 12nm design point).
Absolute energy therefore carries these constants' uncertainty; the paper's
*claims* we validate are fractions (non-Conv share) and ratios (DSE gains),
which are insensitive to uniform constant scaling.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Dict, Mapping, Union

import numpy as np

from .hardware import HardwareSpec


class _TorchNamespace:
    """The array functions the batched energy/objective math calls, in
    torch on one device (``array_namespace`` of a tensor).  ``asarray``
    moves host values there; numpy's ``dtype=float`` is ``torch.float64``,
    and without a dtype a host value keeps the dtype numpy gives it
    (float64 for a Python float, where torch would make float32)."""

    def __init__(self, device):
        import torch
        self._torch = torch
        self.device = device

    def asarray(self, x, dtype=None):
        torch = self._torch
        if dtype is float:
            dtype = torch.float64
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def where(self, cond, x, y):
        return self._torch.where(cond, x, y)

    def zeros_like(self, x):
        return self._torch.zeros_like(x)


def array_namespace(x) -> object:
    """A torch namespace on ``x``'s device if ``x`` is a torch tensor,
    else ``numpy``.  Keeps the batched energy/objective math on whichever
    device composed the cycles grid (the torch DSE backends score there)
    without importing torch on the numpy path -- if ``x`` is a tensor,
    torch is necessarily already in ``sys.modules``."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(x, torch.Tensor):
        return _TorchNamespace(x.device)
    return np

PJ = 1e-12

ArrayLike = Union[int, float, np.ndarray]


@dataclass(frozen=True)
class EnergyModel:
    t_clk_s: float = 1e-9
    e_dram_pj_per_bit: float = 3.9
    mac_dyn_w_16b: float = 0.35e-3
    mac_dyn_w_8b: float = 0.12e-3
    alu_dyn_w: float = 0.6e-3
    leak_frac: float = 0.08

    def e_sram_pj_per_bit(self, size_bytes: ArrayLike) -> ArrayLike:
        """Per-bit SRAM access energy; accepts a scalar size in bytes or an
        ndarray of sizes (one per design-space candidate)."""
        if np.ndim(size_bytes) == 0:
            kb = max(1.0, size_bytes / 1024.0)
            return 0.035 * (kb / 32.0) ** 0.25
        kb = np.maximum(1.0, np.asarray(size_bytes, dtype=float) / 1024.0)
        return 0.035 * (kb / 32.0) ** 0.25

    def p_sa_dyn(self, hw: HardwareSpec) -> float:
        per_mac = self.mac_dyn_w_16b if hw.b_w >= 16 else self.mac_dyn_w_8b
        return hw.J * hw.K * per_mac

    def p_simd_dyn(self, hw: HardwareSpec) -> float:
        return hw.K * self.alu_dyn_w

    def p_sa_leak(self, hw: HardwareSpec) -> float:
        return self.leak_frac * self.p_sa_dyn(hw)

    def p_simd_leak(self, hw: HardwareSpec) -> float:
        return self.leak_frac * self.p_simd_dyn(hw)


DEFAULT_ENERGY = EnergyModel()


def compute_energy(hw: HardwareSpec,
                   c_sa: int, c_simd: int, l_total: int,
                   sram_bits: Dict[str, int], dram_bits: int,
                   em: EnergyModel = DEFAULT_ENERGY) -> Dict[str, float]:
    """Returns a breakdown in Joules + average power in Watts."""
    e_sa = (c_sa * em.p_sa_dyn(hw) + l_total * em.p_sa_leak(hw)) * em.t_clk_s
    e_simd = (c_simd * em.p_simd_dyn(hw)
              + l_total * em.p_simd_leak(hw)) * em.t_clk_s

    buf_size = {"wbuf": hw.wbuf, "ibuf": hw.ibuf, "obuf": hw.obuf,
                "bbuf": hw.bbuf, "vmem": hw.vmem, "imem": hw.imem}
    e_s = sum(bits * em.e_sram_pj_per_bit(buf_size.get(buf, hw.vmem)) * PJ
              for buf, bits in sram_bits.items())
    e_d = dram_bits * em.e_dram_pj_per_bit * PJ

    e_total = e_sa + e_simd + e_s + e_d
    runtime_s = l_total * em.t_clk_s
    return {
        "E_SA": e_sa, "E_SIMD": e_simd, "E_S": e_s, "E_D": e_d,
        "E_total": e_total,
        "runtime_s": runtime_s,
        "P_avg": (e_total / runtime_s) if runtime_s > 0 else 0.0,
    }


# Canonical buffer order of the batched SRAM-energy sum.  It matches the
# insertion order of ``NetworkReport.sram_bits_by_buffer()`` on conv-first
# networks (all paper workloads), so the sequential accumulation below adds
# the same terms in the same order as the scalar ``compute_energy`` —
# float-identical, not merely close.
SRAM_BUFFER_ORDER = ("wbuf", "ibuf", "obuf", "bbuf", "vmem")


def compute_energy_batch(hw: HardwareSpec, *,
                         c_sa: ArrayLike, c_simd: ArrayLike,
                         l_total: ArrayLike,
                         sram_bits: Mapping[str, ArrayLike],
                         sram_sizes: Mapping[str, ArrayLike],
                         dram_bits: ArrayLike,
                         em: EnergyModel = DEFAULT_ENERGY
                         ) -> Dict[str, np.ndarray]:
    """Vectorized ``compute_energy``: every input may be an ndarray of
    per-candidate values (broadcast against each other), and — unlike the
    scalar path, where one ``hw`` fixes every buffer size — ``sram_sizes``
    carries a per-candidate size array for each buffer, so one call prices
    an entire design-space grid.  Term structure and accumulation order
    mirror the scalar function exactly (Eqs. 29-32).

    ``l_total`` may be a torch tensor (the torch DSE backends): every
    term over it is elementwise, so the report stays on its device with
    the same IEEE operations in the same order -- bit-identical to the
    numpy path.  The per-candidate columns that do not involve it
    (``c_sa * P_SA_dyn``, ``c_simd * P_SIMD_dyn``, E_S, E_D) are computed
    on the host as on the numpy path, then moved to the device once.
    ``l_total`` turns float64 before it is scaled: torch scales an int64
    tensor by a Python float in float32, numpy converts it to float64
    first -- the conversion made here.  No division by a Python scalar
    (CUDA multiplies by its reciprocal) and no fused multiply-add."""
    xp = array_namespace(l_total)
    cycles = xp.asarray(l_total, dtype=float)
    e_sa = (xp.asarray(c_sa * em.p_sa_dyn(hw))
            + cycles * em.p_sa_leak(hw)) * em.t_clk_s
    e_simd = (xp.asarray(c_simd * em.p_simd_dyn(hw))
              + cycles * em.p_simd_leak(hw)) * em.t_clk_s

    e_s = 0.0
    for buf in SRAM_BUFFER_ORDER:
        if buf in sram_bits:
            e_s = e_s + (sram_bits[buf]
                         * em.e_sram_pj_per_bit(sram_sizes[buf]) * PJ)
    for buf in sram_bits:            # non-canonical buffers, if any
        if buf not in SRAM_BUFFER_ORDER:
            e_s = e_s + (sram_bits[buf]
                         * em.e_sram_pj_per_bit(sram_sizes[buf]) * PJ)
    e_s = xp.asarray(e_s)
    e_d = xp.asarray(dram_bits * em.e_dram_pj_per_bit * PJ)

    e_total = e_sa + e_simd + e_s + e_d
    runtime_s = cycles * em.t_clk_s
    with np.errstate(divide="ignore", invalid="ignore"):
        p_avg = xp.where(runtime_s > 0, e_total / runtime_s, 0.0)
    return {
        "E_SA": xp.asarray(e_sa, dtype=float),
        "E_SIMD": xp.asarray(e_simd, dtype=float),
        "E_S": xp.asarray(e_s + xp.zeros_like(runtime_s), dtype=float),
        "E_D": xp.asarray(e_d + xp.zeros_like(runtime_s), dtype=float),
        "E_total": xp.asarray(e_total, dtype=float),
        "runtime_s": runtime_s,
        "P_avg": p_avg,
    }

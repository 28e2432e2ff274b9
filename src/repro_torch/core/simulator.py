"""End-to-end SimDIT simulator (paper Fig. 1), the port's own copy of the
JAX package's ``repro/core/simulator.py`` (its relative imports now reach
the port's copies of the cost model).

Input : HardwareSpec + a layer list (DNN Specifications) [+ optional
        externally-supplied tilings, mirroring the paper's compiler hook].
Output: per-layer and aggregate performance statistics — cycle counts
        (compute + DRAM stall), on-chip / off-chip access counts, op
        counts — plus the Sec. VI energy/power rollup and a Conv vs
        non-Conv breakdown (the paper's headline analysis, Tables VI-VII).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

from .backward import expand_training_graph
from .conv_model import PerfStats, simulate_conv
from .energy import DEFAULT_ENERGY, EnergyModel, compute_energy
from .hardware import HardwareSpec
from .layers import ConvLayer, SimdLayer
from .networks import NETWORKS
from .simd_model import simulate_simd
from .tiling import ConvTiling, SimdTiling

Layer = Union[ConvLayer, SimdLayer]


@dataclass
class LayerReport:
    name: str
    engine: str
    phase: str
    op: str
    stats: PerfStats


@dataclass
class _Aggregates:
    """One-pass rollup of a layer list: per-engine cycle/traffic sums so the
    NetworkReport properties stop re-scanning every layer on each access."""
    total_cycles: int = 0
    stall_cycles: int = 0
    compute_by_engine: Dict[str, int] = field(default_factory=dict)
    cycles_by_engine: Dict[str, int] = field(default_factory=dict)
    cycles_by_phase: Dict[str, int] = field(default_factory=dict)
    dram_by_engine: Dict[str, int] = field(default_factory=dict)
    sram_by_engine: Dict[str, int] = field(default_factory=dict)
    dram_total: int = 0
    sram_total: int = 0
    sram_by_buffer: Dict[str, int] = field(default_factory=dict)
    ops: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def scan(cls, layers: List["LayerReport"]) -> "_Aggregates":
        ag = cls()
        for r in layers:
            s = r.stats
            tc = s.total_cycles
            dram = s.dram_total_bits
            sram = s.sram_total_bits
            ag.total_cycles += tc
            ag.stall_cycles += s.stall_cycles
            e = r.engine
            ag.compute_by_engine[e] = \
                ag.compute_by_engine.get(e, 0) + s.compute_cycles
            ag.cycles_by_engine[e] = ag.cycles_by_engine.get(e, 0) + tc
            # same namespaced keys as the DSE phase grids ('sa' -> 'conv')
            pk = f"{'conv' if e == 'sa' else 'simd'}:{r.phase}"
            ag.cycles_by_phase[pk] = ag.cycles_by_phase.get(pk, 0) + tc
            ag.dram_by_engine[e] = ag.dram_by_engine.get(e, 0) + dram
            ag.sram_by_engine[e] = ag.sram_by_engine.get(e, 0) + sram
            ag.dram_total += dram
            ag.sram_total += sram
            for k, v in s.sram_bits.items():
                ag.sram_by_buffer[k] = ag.sram_by_buffer.get(k, 0) + v
            for k, v in s.ops.items():
                ag.ops[k] = ag.ops.get(k, 0) + v
        return ag


@dataclass
class NetworkReport:
    layers: List[LayerReport] = field(default_factory=list)
    _agg: Optional[_Aggregates] = field(default=None, repr=False, compare=False)
    _agg_len: int = field(default=-1, repr=False, compare=False)

    # ---- aggregates --------------------------------------------------------
    def _aggregates(self) -> _Aggregates:
        """Cached one-pass rollup; recomputed when layers are appended or
        removed (keyed on the list length — replacing a layer in place
        without changing the count is not supported)."""
        if self._agg is None or self._agg_len != len(self.layers):
            self._agg = _Aggregates.scan(self.layers)
            self._agg_len = len(self.layers)
        return self._agg

    @property
    def total_cycles(self) -> int:
        return self._aggregates().total_cycles

    @property
    def compute_cycles_sa(self) -> int:
        return self._aggregates().compute_by_engine.get("sa", 0)

    @property
    def compute_cycles_simd(self) -> int:
        return self._aggregates().compute_by_engine.get("simd", 0)

    @property
    def stall_cycles(self) -> int:
        return self._aggregates().stall_cycles

    def cycles(self, engine: Optional[str] = None) -> int:
        ag = self._aggregates()
        return ag.total_cycles if engine is None \
            else ag.cycles_by_engine.get(engine, 0)

    def dram_bits(self, engine: Optional[str] = None) -> int:
        ag = self._aggregates()
        return ag.dram_total if engine is None \
            else ag.dram_by_engine.get(engine, 0)

    def sram_bits(self, engine: Optional[str] = None) -> int:
        ag = self._aggregates()
        return ag.sram_total if engine is None \
            else ag.sram_by_engine.get(engine, 0)

    def sram_bits_by_buffer(self) -> Dict[str, int]:
        return dict(self._aggregates().sram_by_buffer)

    def ops(self) -> Dict[str, int]:
        return dict(self._aggregates().ops)

    def cycles_by_phase(self) -> Dict[str, int]:
        """Phase-resolved cycle attribution, keyed like the DSE phase
        grids ('conv:fwd', 'conv:bwd_dx', 'conv:bwd_dw', 'simd:fwd',
        'simd:bwd'); values sum exactly to ``total_cycles``."""
        return dict(self._aggregates().cycles_by_phase)

    def phase_shares(self) -> Dict[str, float]:
        """Each phase's fraction of total cycles."""
        tot = self.total_cycles
        return {k: (v / tot if tot else 0.0)
                for k, v in self._aggregates().cycles_by_phase.items()}

    def nonconv_fraction(self, metric: str = "cycles") -> float:
        """Fraction of the metric attributable to non-Conv (SIMD) layers."""
        if metric == "cycles":
            tot, sub = self.cycles(), self.cycles("simd")
        elif metric == "dram":
            tot, sub = self.dram_bits(), self.dram_bits("simd")
        elif metric == "sram":
            tot, sub = self.sram_bits(), self.sram_bits("simd")
        else:
            raise ValueError(metric)
        return sub / tot if tot else 0.0

    def energy_inputs(self) -> Dict[str, object]:
        """The exact per-network quantities ``energy()`` hands to
        ``compute_energy`` — busy cycles per engine, total cycles, SRAM
        bits by buffer, DRAM bits.  The DSE cost tables carry the same
        five quantities per candidate; exposing them here is what lets
        the batched energy tensors be validated against the simulator."""
        return dict(
            c_sa=self.compute_cycles_sa,
            c_simd=self.compute_cycles_simd,
            l_total=self.total_cycles,
            sram_bits=self.sram_bits_by_buffer(),
            dram_bits=self.dram_bits())

    def energy(self, hw: HardwareSpec,
               em: EnergyModel = DEFAULT_ENERGY) -> Dict[str, float]:
        return compute_energy(hw, em=em, **self.energy_inputs())

    def nonconv_energy_fraction(self, hw: HardwareSpec,
                                em: EnergyModel = DEFAULT_ENERGY) -> float:
        """Energy attribution: SIMD compute + SIMD-side accesses vs total.

        Leakage is apportioned by each engine's share of total cycles."""
        conv = NetworkReport([r for r in self.layers if r.engine == "sa"])
        nonc = NetworkReport([r for r in self.layers if r.engine == "simd"])
        tot = self.energy(hw, em)["E_total"]
        if tot <= 0:
            return 0.0
        e_n = compute_energy(hw, c_sa=0,
                             c_simd=nonc.compute_cycles_simd,
                             l_total=nonc.total_cycles,
                             sram_bits=nonc.sram_bits_by_buffer(),
                             dram_bits=nonc.dram_bits(), em=em)["E_total"]
        return e_n / tot


def simulate_network(hw: HardwareSpec, net: List[Layer],
                     stall_model: str = "simdit",
                     tilings: Optional[Dict[str, Union[ConvTiling, SimdTiling]]] = None,
                     ) -> NetworkReport:
    report = NetworkReport()
    tilings = tilings or {}
    for layer in net:
        if isinstance(layer, ConvLayer):
            stats = simulate_conv(hw, layer, tilings.get(layer.name),
                                  stall_model=stall_model)
            report.layers.append(LayerReport(layer.name, "sa", layer.phase,
                                             layer.kind, stats))
        else:
            stats = simulate_simd(hw, layer, tilings.get(layer.name),
                                  stall_model=stall_model)
            report.layers.append(LayerReport(layer.name, "simd", layer.phase,
                                             layer.op, stats))
    return report


def simulate(hw: HardwareSpec, network: str, mode: str = "inference",
             batch: Optional[int] = None,
             stall_model: str = "simdit") -> NetworkReport:
    """Convenience entry: network name + phase -> report.

    mode='inference' uses batch=1 by default; mode='training' expands the
    graph per Table I and uses batch=32 by default (paper Sec. VII-A).
    """
    if batch is None:
        batch = 1 if mode == "inference" else 32
    # BN is a training-phase layer (Sec. V-A); inference graphs are BN-folded.
    net = NETWORKS[network](batch, bn=(mode == "training"))
    if mode == "training":
        net = expand_training_graph(net)
    return simulate_network(hw, net, stall_model=stall_model)

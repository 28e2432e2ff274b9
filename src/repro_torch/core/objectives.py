"""First-class DSE objectives — the metric axis of the search API.

The paper's deliverable is end-to-end statistics (cycles, access counts,
energy, power — Secs. IV-VI), but a search has to *reduce* them to one
figure of merit per candidate.  An ``Objective`` is that reduction,
expressed over *batches* of candidates so both search front-ends keep
their vectorized evaluation: the exhaustive grid scores its whole
[sizes x bandwidths] cost matrix in one call, the refine front-end scores
each proposed neighborhood.

``MetricBatch`` is the data contract between an engine and an objective:
``cycles`` is always present (int64, any shape); the energy-derived
metrics (``energy``, ``edp``, ``power``, ``runtime_s``) are computed
lazily from the per-candidate busy-cycle / SRAM-bit / DRAM-bit tensors
the cost tables carry (see ``ConvTable``/``SimdTable`` in ``core.dse``)
and cached, so a pure-cycles search never pays for them.

Scores are *minimized*; ``float('inf')`` marks an infeasible candidate
(e.g. over a power cap).  Ship objectives:

  * ``cycles``                 — end-to-end latency (the legacy metric)
  * ``energy``                 — total energy E_total (Eq. 29)
  * ``edp``                    — energy-delay product E_total * runtime
  * ``cycles_under_power_cap`` — latency among candidates with
                                 P_avg <= cap_w (Eq. 32); needs a cap, so
                                 instantiate ``CyclesUnderPowerCap(cap_w=...)``

Custom objectives: subclass ``Objective`` (or any object with ``name``,
``needs_energy`` and ``score``) and either pass the instance directly to
``Study.search`` or ``register_objective`` a zero-arg factory for a
string name.

On the torch DSE backends a ``MetricBatch`` carries the device grid:
every metric is a torch tensor on the search's device, and the shipped
objectives score it there (``energy.array_namespace``).  A numpy-only
objective keeps working, as it does on a jax grid: ``np.asarray`` of a
metric copies it to the host (``gridtorch.HostReadable``), and a numpy
score goes back to the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import numpy as np

from .energy import array_namespace


class MetricBatch:
    """Per-candidate metrics for one batch (or grid) of design points.

    ``cycles`` is eager; the energy report — the dict ``compute_energy``
    returns, vectorized per candidate — is produced lazily by the
    engine-supplied thunk and cached across metric accesses.  Both are
    numpy arrays on the host engines and torch tensors on the device
    grid of the torch backends.
    """

    def __init__(self, cycles: np.ndarray,
                 energy_fn: Optional[Callable[[], Dict[str, np.ndarray]]]
                 = None):
        self.cycles = cycles
        self._energy_fn = energy_fn
        self._report: Optional[Dict[str, np.ndarray]] = None

    def energy_report(self) -> Dict[str, np.ndarray]:
        if self._report is None:
            if self._energy_fn is None:
                raise ValueError(
                    "this engine supplied no energy tensors; the objective "
                    "requires them (needs_energy=True)")
            self._report = self._energy_fn()
        return self._report

    @property
    def energy(self) -> np.ndarray:
        """E_total, Joules (Eq. 29)."""
        return self.energy_report()["E_total"]

    @property
    def runtime_s(self) -> np.ndarray:
        return self.energy_report()["runtime_s"]

    @property
    def power(self) -> np.ndarray:
        """P_avg, Watts (Eq. 32)."""
        return self.energy_report()["P_avg"]

    @property
    def edp(self) -> np.ndarray:
        """Energy-delay product, Joule-seconds."""
        return self.energy * self.runtime_s


class Objective:
    """A batched reduction of per-candidate metrics to a minimized score.

    ``score`` must be shape-preserving (elementwise over the batch) and
    may return ``inf`` for infeasible candidates.  ``needs_energy`` lets
    engines skip assembling energy tensors for pure-cycle searches."""

    name: str = "objective"
    needs_energy: bool = False

    def score(self, m: MetricBatch) -> np.ndarray:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class Cycles(Objective):
    """End-to-end cycles — the legacy (and default) metric.  Scores are
    the int64 cycle counts themselves, so results are bit-identical to
    the pre-objective API."""

    name = "cycles"
    needs_energy = False

    def score(self, m: MetricBatch) -> np.ndarray:
        return m.cycles


class Energy(Objective):
    """Total energy E_total (Eq. 29), Joules."""

    name = "energy"
    needs_energy = True

    def score(self, m: MetricBatch) -> np.ndarray:
        return m.energy


class EDP(Objective):
    """Energy-delay product E_total * runtime, Joule-seconds."""

    name = "edp"
    needs_energy = True

    def score(self, m: MetricBatch) -> np.ndarray:
        return m.edp


@dataclass(frozen=True)
class CyclesUnderPowerCap(Objective):
    """Min-cycles subject to P_avg <= cap_w: candidates over the cap
    score ``inf`` (infeasible), the rest score their cycles."""

    cap_w: float = float("inf")

    name = "cycles_under_power_cap"
    needs_energy = True

    def score(self, m: MetricBatch) -> np.ndarray:
        # xp dispatch keeps torch metric batches (the torch DSE backends)
        # on their device; the numpy path is byte-for-byte the legacy one
        xp = array_namespace(m.cycles)
        return xp.where(xp.asarray(m.power) <= self.cap_w,
                        xp.asarray(m.cycles, dtype=float), np.inf)

    def __repr__(self) -> str:
        return f"CyclesUnderPowerCap(cap_w={self.cap_w})"


OBJECTIVES: Dict[str, Callable[[], Objective]] = {
    "cycles": Cycles,
    "energy": Energy,
    "edp": EDP,
}


def register_objective(name: str, factory: Callable[[], Objective]) -> None:
    """Register a zero-arg objective factory under a string name."""
    OBJECTIVES[name] = factory


def resolve_objective(obj: Union[None, str, Objective]) -> Objective:
    """None -> cycles; a registered name -> its instance; an Objective
    passes through."""
    if obj is None:
        return Cycles()
    if isinstance(obj, str):
        if obj == "cycles_under_power_cap":
            raise ValueError(
                "cycles_under_power_cap needs a cap: pass "
                "CyclesUnderPowerCap(cap_w=...) instead of the string name")
        try:
            return OBJECTIVES[obj]()
        except KeyError:
            raise ValueError(f"unknown objective {obj!r}; registered: "
                             f"{sorted(OBJECTIVES)}") from None
    if isinstance(obj, Objective):
        return obj
    if all(hasattr(obj, a) for a in ("score", "name", "needs_energy")):
        return obj                     # duck-typed custom objective
    raise TypeError(
        f"objective must be a registered name or an object with "
        f"name/needs_energy/score, got {obj!r}")

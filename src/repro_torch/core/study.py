"""Objective-first DSE front door: ``Workload`` / ``Objective`` / ``Study``.

The paper's deliverable is *end-to-end* statistics — cycles, access
counts, energy, power (Secs. IV-VI) — and its design-space study
(Sec. VII-B) asks allocation questions against them.  This module makes
each axis of such a study a first-class value:

  * ``Workload`` — what runs: a network (by registry name or as a layer
    list), inference or training (Table I expansion), at a batch size.
    Replaces the ad-hoc ``training=True`` kwarg + bare layer sequences.
  * ``Objective`` — what is minimized: a batched reduction over the cost
    tables (``repro_torch.core.objectives``).  Ship: ``cycles``, ``energy``,
    ``edp``, ``CyclesUnderPowerCap(cap_w=...)``.
  * ``Study`` — where the search runs: owns the hardware base, the
    candidate space (lattices, budget tolerance), the energy model, the
    worker pool for parallel table builds, and the front-end registry
    (``method="grid"`` exhaustive / ``method="refine"`` local search).

One study amortizes everything shareable: all its searches draw from the
process-lifetime ``ConvTable``/``SimdTable`` caches, and because the
tables carry the energy tensors alongside cycles, a cycles sweep
followed by an energy (or EDP, or power-capped) sweep over the same
budgets rebuilds *nothing* (``Study.cache_stats``).

    study = Study(HI3, workers=4)
    wl = Workload("resnet50")                       # inference, batch 1
    res = study.search(wl, 2048, 2048, objective="edp")
    res.best, res.energy_report(), res.pareto()     # 2-D cycles/energy

The legacy ``repro_torch.core.dse.search``/``search_many`` survive as thin
deprecation shims over a default ``Study``, bit-identical under the
default cycles objective.
"""
from __future__ import annotations

import contextlib
import inspect
import random
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from . import faultinject
from .backward import expand_training_graph
from .dse import (BWS, SEARCH_METHODS, SIZES_KB, DSEPoint, DSEResult, Layer,
                  clear_table_caches, resolve_backend, table_cache_stats)
from .energy import DEFAULT_ENERGY, EnergyModel
from .hardware import KB, HardwareSpec
from .layers import ConvLayer, GemmLayer, SimdLayer
from .objectives import Objective, resolve_objective
from .store import TableStore, env_int, store_context

WORKERS_ENV = "REPRO_DSE_WORKERS"
SELFCHECK_ENV = "REPRO_DSE_SELFCHECK"


def default_workers() -> int:
    """Worker-process default for parallel table builds: the
    ``REPRO_DSE_WORKERS`` environment variable, else 0 (serial).  A
    garbage value warns (``RuntimeWarning`` naming it) and falls back —
    never a silent serial run."""
    return max(0, env_int(WORKERS_ENV, 0))


def default_selfcheck() -> int:
    """Self-check sample count default: the ``REPRO_DSE_SELFCHECK``
    environment variable (candidates cross-validated per search), else 0
    (off).  Garbage values warn and fall back like ``default_workers``."""
    return max(0, env_int(SELFCHECK_ENV, 0))


class IntegrityError(RuntimeError):
    """A batched DSE result diverged from the independent scalar walk.

    Raised by the opt-in self-check mode (``REPRO_DSE_SELFCHECK=n`` /
    ``Study(selfcheck=n)``): the batched cost tables and the scalar
    reference tiling+simulator path are pinned bit-identical, so any
    divergence means a corrupted cached table, a poisoned store entry
    that validated, or a real batched-vs-scalar regression.  Structured
    fields: ``workload`` (the search key), ``point`` (the diverging
    ``DSEPoint``), ``expected`` (scalar reference cycles), ``actual``
    (batched cycles)."""

    def __init__(self, workload: str, point: DSEPoint,
                 expected: int, actual: int):
        self.workload = workload
        self.point = point
        self.expected = expected
        self.actual = actual
        super().__init__(
            f"DSE self-check failed for workload {workload!r} at "
            f"sizes_kb={point.sizes_kb} bws={point.bws}: batched path "
            f"reports {actual} cycles, scalar reference walk reports "
            f"{expected}")


def _reference_point_cycles(hw_base: HardwareSpec,
                            layers: Sequence[Layer],
                            point: DSEPoint) -> int:
    """Independent scalar evaluation of one candidate: reference tiling
    derivation + per-layer simulator, bypassing every cache and table so
    a poisoned ``ConvTable``/``SimdTable`` cannot vouch for itself."""
    from .conv_model import simulate_conv
    from .gemm_model import simulate_gemm
    from .simd_model import simulate_simd
    from .tiling import (derive_conv_tiling_reference,
                         derive_gemm_tiling_reference,
                         derive_simd_tiling_reference)
    wb, ib, ob, vm = point.sizes_kb
    bw_w, bw_i, bw_o, bw_v = point.bws
    hw = hw_base.replace(wbuf=wb * KB, ibuf=ib * KB, obuf=ob * KB,
                         vmem=vm * KB, bw_w=bw_w, bw_i=bw_i,
                         bw_o=bw_o, bw_v=bw_v)
    total = 0
    for layer in layers:
        if isinstance(layer, ConvLayer):
            t = derive_conv_tiling_reference(hw, layer)
            total += simulate_conv(hw, layer, t).total_cycles
        elif isinstance(layer, GemmLayer):
            t = derive_gemm_tiling_reference(hw, layer)
            total += simulate_gemm(hw, layer, t).total_cycles
        else:
            t = derive_simd_tiling_reference(hw, layer)
            total += simulate_simd(hw, layer, t).total_cycles
    return total


@dataclass(frozen=True)
class Workload:
    """What runs on the accelerator: a network, a phase, a batch size.

    ``net`` is either a name in ``repro_torch.core.networks.NETWORKS``, an
    LLM config name (``repro_torch.models.frontends.llm_config_names`` —
    lowered to a GEMM + SIMD graph), or an explicit layer sequence (stored
    as a tuple).  ``training=True`` selects the Table I training expansion
    (and, for named CNNs, the BN-bearing graph); ``batch`` defaults to
    the paper's setup for CNNs — 1 for inference, 32 for training
    (Sec. VII-A) — and to 1 for LLM configs (their token count is
    ``batch * seq``); it only applies to named networks (an explicit
    layer list already fixes its batch).  ``seq`` sets the LLM sequence
    length (default ``LLM_SEQ_DEFAULT``) and is invalid elsewhere."""
    net: Union[str, Tuple[Layer, ...]]
    training: bool = False
    batch: Optional[int] = None
    name: Optional[str] = None
    seq: Optional[int] = None

    def __post_init__(self):
        if not isinstance(self.net, (str, tuple)):
            object.__setattr__(self, "net", tuple(self.net))
        if not isinstance(self.net, str):
            if self.batch is not None:
                raise ValueError("batch applies to named networks only; an "
                                 "explicit layer list already fixes its "
                                 "batch")
            if self.seq is not None:
                raise ValueError("seq applies to named LLM configs only; "
                                 "an explicit layer list already fixes "
                                 "its shapes")

    @property
    def label(self) -> str:
        if self.name:
            return self.name
        base = self.net if isinstance(self.net, str) else "net"
        return f"{base}:train" if self.training else base

    def layers(self) -> List[Layer]:
        """The concrete layer list, training-expanded when asked.  Named
        CNNs follow ``simulate``'s conventions: BN layers appear only in
        training graphs (inference graphs are BN-folded).  Names not in
        the CNN registry resolve as LLM configs and lower to a GEMM +
        SIMD graph (``repro_torch.models.frontends.lower_llm``)."""
        if isinstance(self.net, str):
            from .networks import NETWORKS
            if self.net in NETWORKS:
                if self.seq is not None:
                    raise ValueError(
                        f"seq applies to LLM configs only; {self.net!r} "
                        f"is a CNN registry network")
                batch = self.batch if self.batch is not None \
                    else (32 if self.training else 1)
                net = NETWORKS[self.net](batch, bn=self.training)
            else:
                from ..models.frontends import (llm_config_names,
                                                lower_llm,
                                                resolve_llm_config)
                cfg = resolve_llm_config(self.net)
                if cfg is None:
                    raise ValueError(
                        f"unknown network {self.net!r}; registered CNN "
                        f"networks: {sorted(NETWORKS)}; LLM configs: "
                        f"{llm_config_names()}")
                net = lower_llm(cfg, batch=self.batch or 1, seq=self.seq)
        else:
            net = list(self.net)
        return expand_training_graph(net) if self.training else net


def as_workload(w: Union[Workload, str, Sequence[Layer]]) -> Workload:
    """Coerce a workload spec: a ``Workload`` passes through, a string
    names a registry network (inference), a layer sequence wraps as an
    inference workload."""
    if isinstance(w, Workload):
        return w
    if isinstance(w, str):
        return Workload(net=w)
    if isinstance(w, Sequence) and all(
            isinstance(l, (ConvLayer, GemmLayer, SimdLayer)) for l in w):
        return Workload(net=tuple(w))
    raise TypeError(f"cannot interpret {w!r} as a Workload")


@dataclass(frozen=True)
class SweepRequest:
    """One self-contained DSE query: workload + budgets + metric + method.

    ``search_many`` prices several *workloads* under ONE budget pair and
    objective; a ``SweepRequest`` additionally carries its own budgets,
    objective, and front-end, so heterogeneous queries — different
    networks, budgets, objectives, inference and training — become plain
    values that can be queued, grouped, and deduplicated.  This is the
    unit the serving subsystem (``repro_torch.serve``) moves around; the
    synchronous batch entry is ``Study.search_requests``.

    ``objective`` is a registered name or an ``Objective`` instance.
    Requests group (and dedup) on string names by value and on instances
    by *identity*: two ``CyclesUnderPowerCap(cap_w=...)`` objects with
    different caps share a class-level ``name``, so identity is the only
    safe sharing key — pass the same instance to queries that should
    coalesce."""
    workload: Workload
    size_budget_kb: int
    bw_budget: int
    objective: Union[str, Objective, None] = "cycles"
    method: str = "grid"

    def __post_init__(self):
        object.__setattr__(self, "workload", as_workload(self.workload))

    def _objective_token(self):
        obj = self.objective
        if obj is None:
            return "cycles"
        return obj if isinstance(obj, str) else id(obj)

    @property
    def group_key(self) -> tuple:
        """Requests with equal group keys are priced by ONE
        ``search_many`` call (same budgets/objective/method — only the
        workloads differ)."""
        return (int(self.size_budget_kb), int(self.bw_budget),
                self._objective_token(), self.method)

    @property
    def dedup_key(self) -> tuple:
        """Full query identity: equal keys mean bit-identical answers,
        so in-flight duplicates can share one result."""
        return (self.workload, *self.group_key)


class Study:
    """One design-space study: hardware base + candidate space + caches.

    Every ``search``/``search_many`` call runs over this study's lattice
    (``sizes`` x ``bws``, four coordinates each, filtered to the +-``tol``
    budget band) with its energy model and worker pool; front-ends come
    from its method registry (``"grid"`` and ``"refine"`` built in,
    ``register_method`` for custom ones).

    The default ``workers=0`` serial path is the fast path: uncached
    per-size-triple ``ConvTable``s are batch-built through the vectorized
    greedy tiling derivation — one numpy pass per layer shape covers the
    study's whole candidate lattice (``dse.batch_build_conv_tables``).
    ``workers > 1`` instead fans scalar builds out across forked
    processes, the *many-core* option for very heavy shape unions where
    fork+pickle overhead amortizes; results stay bit-identical either
    way, defaulting to ``$REPRO_DSE_WORKERS``.

    ``store`` pins this study's persistent table store (a ``TableStore``,
    a directory path, or ``None`` to force the store off even when
    ``$REPRO_TABLE_STORE`` is set); left at the default, resolution
    follows the process-wide rules in ``repro_torch.core.store``.
    ``selfcheck=n`` (default ``$REPRO_DSE_SELFCHECK``, else off)
    cross-validates n sampled candidates of every search against the
    scalar reference walk and raises ``IntegrityError`` on divergence.

    ``backend`` picks where the exhaustive front-end's grid reductions
    run — ``"numpy"`` (host), ``"torch"`` (torch reductions on
    ``device``), or ``"torch-fused"`` (the default: torch reductions with
    best/worst through the CUDA grid min/max kernel); ``None`` follows
    ``$REPRO_DSE_BACKEND``.  All backends are pinned bit-identical
    (``repro_torch.core.gridtorch``); front-ends that don't take a
    ``backend`` parameter (``"refine"``, whose scalar neighborhoods are
    priced on the host's numpy tables, and third-party registrations) are
    called without it.  ``device`` is the torch device of the reductions,
    forwarded the same way: ``"cuda"`` by default, and construction raises
    when CUDA is absent — a study runs on the CPU only when asked
    (``device="cpu"``).
    """

    _INHERIT = object()          # store default: follow env/global rules

    def __init__(self, hw: HardwareSpec, *,
                 sizes: Sequence[int] = SIZES_KB,
                 bws: Sequence[int] = BWS,
                 tol: float = 0.15, lower_bound: bool = True,
                 energy_model: EnergyModel = DEFAULT_ENERGY,
                 workers: Optional[int] = None,
                 store: Union[TableStore, str, Path, None] = _INHERIT,
                 selfcheck: Optional[int] = None,
                 methods: Optional[Dict[str, object]] = None,
                 backend: Optional[str] = None,
                 device="cuda"):
        from .gridtorch import resolve_device
        self.hw = hw
        self.sizes = tuple(sizes)
        self.bws = tuple(bws)
        self.tol = tol
        self.lower_bound = lower_bound
        self.energy_model = energy_model
        self.workers = default_workers() if workers is None else int(workers)
        self.store = store
        self.selfcheck = default_selfcheck() if selfcheck is None \
            else max(0, int(selfcheck))
        self._methods = methods
        self.backend = resolve_backend(backend)
        self.device = resolve_device(device)

    # ---- front-end registry ----------------------------------------------

    def register_method(self, name: str, fn) -> None:
        """Register a search front-end on this study only (the global
        registry in ``repro_torch.core.dse`` is untouched)."""
        if self._methods is None:
            self._methods = dict(SEARCH_METHODS)
        self._methods[name] = fn

    def _resolve_method(self, method: str):
        registry = self._methods if self._methods is not None \
            else SEARCH_METHODS
        fn = registry.get(method)
        if fn is None and method == "refine":
            from . import optimize                    # registers itself
            del optimize
            fn = SEARCH_METHODS.get(method)
            if self._methods is not None:
                self._methods.setdefault(method, fn)
        if fn is None:
            raise ValueError(f"unknown search method {method!r}; "
                             f"registered: {sorted(registry)}")
        return fn

    # ---- searching --------------------------------------------------------

    def search_many(self,
                    workloads: Mapping[str, Union[Workload, str,
                                                  Sequence[Layer]]],
                    size_budget_kb: int, bw_budget: int, *,
                    objective: Union[str, Objective, None] = "cycles",
                    method: str = "grid",
                    refine=None) -> Dict[str, DSEResult]:
        """Search several workloads at once, sharing the union-of-shapes
        cost tables (a Table IX style sweep builds each table once).
        Returns ``{key: DSEResult}`` scored in ``objective``."""
        obj = resolve_objective(objective)
        nets = {key: as_workload(w).layers()
                for key, w in workloads.items()}
        fn = self._resolve_method(method)
        kwargs = dict(sizes=self.sizes, bws=self.bws, tol=self.tol,
                      lower_bound=self.lower_bound, refine=refine,
                      objective=obj, em=self.energy_model,
                      workers=self.workers)
        # forward the grid-evaluation backend and device only to
        # front-ends that declare them (keeps other registrations working
        # unchanged)
        params = inspect.signature(fn).parameters
        var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                     for p in params.values())
        if "backend" in params or var_kw:
            kwargs["backend"] = self.backend
        if "device" in params or var_kw:
            kwargs["device"] = self.device
        ctx = contextlib.nullcontext() if self.store is Study._INHERIT \
            else store_context(self.store)
        with ctx:
            out = fn(self.hw, nets, size_budget_kb, bw_budget, **kwargs)
        if self.selfcheck > 0:
            for key, res in out.items():
                self._self_check(key, nets[key], res,
                                 size_budget_kb, bw_budget)
        return out

    def _self_check(self, key: str, layers: Sequence[Layer],
                    res: DSEResult, size_budget_kb: int,
                    bw_budget: int) -> None:
        """Cross-validate ``selfcheck`` sampled candidates (plus the
        winner) of one result against the scalar reference walk.  The
        sample is deterministic in (workload, budgets), so a divergence
        reproduces run over run."""
        if res.grid is not None:
            count = res.grid.n_candidates
            candidate = res.grid.point
        elif res.archive:
            count = len(res.archive)
            candidate = res.archive.__getitem__
        else:
            return
        rng = random.Random(zlib.crc32(
            f"{key}|{size_budget_kb}|{bw_budget}|{count}".encode()))
        idx = rng.sample(range(count), min(self.selfcheck, count))
        for point in [candidate(i) for i in idx] + [res.best]:
            expected = _reference_point_cycles(self.hw, layers, point)
            f = faultinject.fire("selfcheck_perturb")
            if f is not None:
                expected += int(f.arg or 1)
            if expected != point.cycles:
                raise IntegrityError(key, point, expected, point.cycles)

    def search(self, workload: Union[Workload, str, Sequence[Layer]],
               size_budget_kb: int, bw_budget: int, *,
               objective: Union[str, Objective, None] = "cycles",
               method: str = "grid", refine=None) -> DSEResult:
        """Search one workload; see ``search_many``.

        ``objective`` may be a registered name (``"cycles"``,
        ``"energy"``, ``"edp"``) or an ``Objective`` instance (e.g.
        ``CyclesUnderPowerCap(cap_w=30.0)``); ``method`` one of this
        study's front-ends (``"grid"``/``"refine"``)."""
        wl = as_workload(workload)
        key = wl.label
        return self.search_many({key: wl}, size_budget_kb, bw_budget,
                                objective=objective, method=method,
                                refine=refine)[key]

    def search_requests(self, requests: Sequence[SweepRequest]
                        ) -> List[DSEResult]:
        """Batch-of-workloads entry: price heterogeneous ``SweepRequest``s
        and fan the results back out in request order.

        Requests are grouped on ``SweepRequest.group_key`` (same budgets,
        objective, method) and each group runs as ONE ``search_many``
        call over its workloads, so the group shares union-of-layer-shape
        table builds; across groups, the process-lifetime table caches
        still dedup every size-triple window the budgets overlap on.
        Each result is bit-identical to a standalone ``search`` of the
        same request — the per-network costs of a shared ``search_many``
        are column gathers over the union tables with unchanged summation
        order (pinned in tests/test_service.py).

        This is the synchronous coalescing primitive; ``repro_torch.serve``
        wraps it with a queue, admission control, deduplication, fault
        isolation, and metrics."""
        requests = [r if isinstance(r, SweepRequest) else SweepRequest(*r)
                    for r in requests]
        groups: Dict[tuple, List[int]] = {}
        for i, req in enumerate(requests):
            groups.setdefault(req.group_key, []).append(i)
        out: List[Optional[DSEResult]] = [None] * len(requests)
        for idx in groups.values():
            head = requests[idx[0]]
            res = self.search_many(
                {f"q{i}": requests[i].workload for i in idx},
                head.size_budget_kb, head.bw_budget,
                objective=head.objective, method=head.method)
            for i in idx:
                out[i] = res[f"q{i}"]
        return out

    # ---- cache ownership --------------------------------------------------

    @staticmethod
    def cache_stats() -> Dict[str, object]:
        """Counters of the shared table caches (``table_cache_stats``)."""
        return table_cache_stats()

    @staticmethod
    def clear_caches() -> None:
        """Drop the shared table caches (benchmark fairness)."""
        clear_table_caches()

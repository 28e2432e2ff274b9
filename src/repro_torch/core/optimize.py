"""Budget-constrained local-search DSE front-end (``method="refine"``).

The exhaustive grid engine (``core.dse``) answers the paper's Table VIII
question — how much does the right SRAM/bandwidth split buy — by sweeping
every power-of-two allocation inside the budget band.  The true optimum,
however, lives *between* lattice points (a 96 kB IBuf is a real design,
and since the tiling generator's exact remainder fill it also gets a
genuinely different tiling), and the 8-parameter grid grows as
``sizes^4 x bws^4``.  This module searches that finer space with a tiny
fraction of the grid's candidate evaluations:

  * **Seeded multi-start coordinate descent.**  Deterministic heuristic
    starts (balanced / conv-heavy / VMem-heavy splits of the budget) plus
    seeded random lattice starts; every run with the same
    ``RefineConfig.seed`` produces the same trajectory.
  * **Batched neighborhoods.**  A descent step proposes the *whole*
    neighborhood of the incumbent at once — single-parameter moves plus
    budget-preserving pairwise transfers — and costs it through the same
    ``ConvTable``/``SimdTable`` batched evaluators as the grid: one
    broadcasted ``np.maximum`` reduction per unique size triple / VMem
    value, never a per-candidate Python loop.
  * **Successive lattice refinement.**  Level 0 walks the caller's
    power-of-two lattice (restricted there, the costs are bit-identical
    to the grid's).  Each later level halves the move stride —
    32 kB, 16, 8, ... down to ``RefineConfig.min_step`` — so the search
    ends on arbitrary integer splits of the budgets.
  * **Table reuse.**  Tables come from the process-lifetime
    ``get_conv_table``/``get_simd_table`` cache, so refinement levels
    revisiting a size triple, repeated seeds, and a grid sweep of the
    same shapes all share builds (``table_cache_stats`` shows the hits).

Every costed candidate is archived as a ``DSEPoint`` (the off-lattice
materialization), the per-phase attribution of *any* point — on-lattice
or off — is re-derived through ``phase_cycles_batch``-style column sums
that partition the total exactly, and the returned ``DSEResult`` supports
the same frontier/economic/phase API as the grid's.

This is the port's own copy of the JAX package's ``core/optimize.py``,
changed only in that ``refine_search_many`` takes no ``backend``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .dse import (DSEPoint, DSEResult, _GridEngine, batch_build_conv_tables,
                  batch_build_gemm_tables, get_conv_table, get_gemm_table,
                  get_simd_table, prefetch_conv_tables, _tuples,
                  register_search_method)
from .energy import DEFAULT_ENERGY, EnergyModel, compute_energy_batch
from .hardware import KB, HardwareSpec
from .objectives import Cycles, MetricBatch, Objective, resolve_objective
from .tiling import prefill_simd_tilings

Tup = Tuple[int, int, int, int]
Cand = Tuple[Tup, Tup]                     # (sizes_kb, bws)


@dataclass(frozen=True)
class RefineConfig:
    """Knobs of the local search.  Defaults are tuned so the Table VIII
    fixtures (+-15% budget bands) finish an order of magnitude under the
    grid's candidate count while never landing above the grid optimum.
    On much wider tolerance bands the default evaluation cap can starve
    the descent before it converges — grant more (e.g. ``max_evals``
    around the grid's candidate count; convergence typically uses only a
    few percent of it)."""
    seed: int = 0
    n_starts: int = 8          # heuristic starts first, then seeded random
    max_evals: Optional[int] = None   # hard cap; None: ~grid_cands / 12
    min_step: int = 1          # finest off-lattice stride (kB / bits-cycle)
    lattice_only: bool = False  # stop after level 0 (grid-equivalence mode)
    max_steps: int = 200       # per-start accepted-move cap (safety)


@dataclass(frozen=True)
class RefineTrace:
    """What the optimizer did: the deterministic trajectory (one entry
    per accepted move: start index, refinement stride, incumbent) plus
    the evaluation accounting the >=10x-fewer-candidates claim rests on."""
    seed: int
    n_starts: int
    n_evals: int               # unique candidates costed
    n_size_triples: int        # unique ConvTables driven
    n_vmems: int               # unique SimdTables driven
    grid_candidates: int       # what the exhaustive sweep would have cost
    trajectory: Tuple[Tuple[int, int, DSEPoint], ...]

    @property
    def eval_saving(self) -> float:
        return self.grid_candidates / max(1, self.n_evals)


# ---------------------------------------------------------------------------
# Batched candidate evaluation over the shared tables
# ---------------------------------------------------------------------------

class _RefineEvaluator:
    """Costs batches of arbitrary (sizes, bws) candidates through the
    union-of-shapes tables, memoizing the two separable projections —
    conv cost at (size triple, bw triple), SIMD cost at (vmem, bw_v) —
    per network, so a revisited projection is a dict lookup and a
    revisited size triple is a table-cache hit.

    Alongside cycles it memoizes the bandwidth-independent *energy*
    components each projection contributes — busy cycles, SRAM bits per
    buffer, DRAM bits, straight off the tables' energy tensors — so the
    descent can score candidates in any ``Objective`` (``scores``) and
    any archived point can be priced after the fact (``energy_at``)."""

    def __init__(self, hw_base: HardwareSpec,
                 nets: Mapping[str, Sequence[object]],
                 objective: Optional[Objective] = None,
                 em: EnergyModel = DEFAULT_ENERGY,
                 workers: int = 0):
        self.hw = hw_base
        self.obj = resolve_objective(objective)
        self.em = em
        self.workers = workers
        self.eng = _GridEngine(hw_base, nets)
        self._conv: Dict[str, Dict[tuple, int]] = {n: {} for n in nets}
        self._simd: Dict[str, Dict[tuple, int]] = {n: {} for n in nets}
        # s3 -> (busy, wbuf, ibuf, obuf, bbuf, dram); vm -> (busy, vmem, dram)
        self._conv_e: Dict[str, Dict[tuple, tuple]] = {n: {} for n in nets}
        self._simd_e: Dict[str, Dict[int, tuple]] = {n: {} for n in nets}
        self._seen: Dict[str, set] = {n: set() for n in nets}
        self.archive: Dict[str, List[DSEPoint]] = {n: [] for n in nets}
        self.archive_scores: Dict[str, List[float]] = {n: [] for n in nets}
        self._s3_seen: Dict[str, set] = {n: set() for n in nets}
        self._vm_seen: Dict[str, set] = {n: set() for n in nets}

    def n_evals(self, name: str) -> int:
        return len(self._seen[name])

    def n_size_triples(self, name: str) -> int:
        return len(self._s3_seen[name])

    def n_vmems(self, name: str) -> int:
        return len(self._vm_seen[name])

    def filter_budget(self, name: str, cands: Sequence[Cand],
                      room: int) -> List[Cand]:
        """Already-counted candidates plus the first ``room`` new ones —
        the hard ``max_evals`` enforcement (deterministic: keeps the
        canonical candidate order)."""
        seen = self._seen[name]
        out: List[Cand] = []
        new = 0
        for c in cands:
            if c in seen:
                out.append(c)
            elif new < room:
                out.append(c)
                new += 1
        return out

    def _conv_fill(self, name: str, need: Dict[tuple, List[tuple]]) -> None:
        """Fill the array-side projection memo — conv *and* GEMM layers
        share the (size triple, bw triple) coordinates, so both fold
        into the same cycle memo and 6-tuple energy components."""
        memo = self._conv[name]
        e_memo = self._conv_e[name]
        cols = self.eng.conv_cols[name]
        gcols = self.eng.gemm_cols[name]
        hws = [self.hw.replace(wbuf=s3[0] * KB, ibuf=s3[1] * KB,
                               obuf=s3[2] * KB) for s3 in need]
        if self.workers > 1:
            prefetch_conv_tables(hws, self.eng._conv_union, self.workers)
        # whole neighborhoods of uncached size triples are batch-built in
        # one vectorized pass per layer (the serial fast path); both
        # builders are clean no-ops on an empty shape union
        batch_build_conv_tables(hws, self.eng._conv_union)
        batch_build_gemm_tables(hws, self.eng._gemm_union)
        for s3, b3s in need.items():
            self._s3_seen[name].add(s3)
            hw = self.hw.replace(wbuf=s3[0] * KB, ibuf=s3[1] * KB,
                                 obuf=s3[2] * KB)
            bw_w = [b[0] for b in b3s]
            bw_i = [b[1] for b in b3s]
            bw_o = [b[2] for b in b3s]
            vals = np.zeros(len(b3s), dtype=np.int64)
            e = [0, 0, 0, 0, 0, 0]
            for table, tcols in (
                    ((get_conv_table(hw, self.eng._conv_union)
                      if cols else None), cols),
                    ((get_gemm_table(hw, self.eng._gemm_union)
                      if gcols else None), gcols)):
                if not tcols:
                    continue
                per_layer = table.layer_cycles_batch(bw_w, bw_i, bw_o)
                vals += per_layer[:, tcols].sum(axis=1).astype(np.int64)
                if s3 not in e_memo:
                    e[0] += int(table.busy[tcols].sum())
                    e[1] += int(table.sram["wbuf"][tcols].sum())
                    e[2] += int(table.sram["ibuf"][tcols].sum())
                    e[3] += int(table.sram["obuf"][tcols].sum())
                    e[4] += int(table.sram["bbuf"][tcols].sum())
                    e[5] += int(table.dram[tcols].sum())
            e_memo.setdefault(s3, tuple(e))
            for b3, v in zip(b3s, vals):
                memo[(s3, b3)] = int(v)

    def _simd_fill(self, name: str, need: Dict[int, List[int]]) -> None:
        memo = self._simd[name]
        e_memo = self._simd_e[name]
        ids = self.eng.simd_ids[name]
        prefill_simd_tilings(self.hw, [vm * KB for vm in need],
                             self.eng._simd_union)
        for vm, wvs in need.items():
            self._vm_seen[name].add(vm)
            table = get_simd_table(self.hw.replace(vmem=vm * KB),
                                   self.eng._simd_union)
            if ids:
                rows = [r for i in ids for r in range(*table.layer_rows[i])]
                compute = sum(table.layer_compute[i] for i in ids)
                stall = table.row_stall_batch(wvs)
                vals = (compute + stall[:, rows].sum(axis=1)) \
                    .astype(np.int64)
                if vm not in e_memo:
                    e_memo[vm] = (int(table.busy[ids].sum()),
                                  int(table.sram_vmem[ids].sum()),
                                  int(table.dram[ids].sum()))
            else:
                vals = np.zeros(len(wvs), dtype=np.int64)
                e_memo.setdefault(vm, (0, 0, 0))
            for w, v in zip(wvs, vals):
                memo[(vm, w)] = int(v)

    def _energy_batch(self, name: str, cands: Sequence[Cand],
                      cycles: np.ndarray) -> Dict[str, np.ndarray]:
        """Vectorized Sec. VI energy report for already-memoized
        candidates, assembled from the per-projection energy components."""
        ce, se = self._conv_e[name], self._simd_e[name]
        try:
            conv = np.array([ce[sz[:3]] for sz, _ in cands], dtype=np.int64)
            simd = np.array([se[sz[3]] for sz, _ in cands], dtype=np.int64)
        except KeyError:
            missing = [sz for sz, _ in cands
                       if sz[:3] not in ce or sz[3] not in se]
            raise ValueError(
                f"point(s) with sizes {missing} were never evaluated by "
                f"this refine run; energy is only available for archived "
                f"candidates") from None
        sizes = np.array([sz for sz, _ in cands], dtype=np.int64)
        return compute_energy_batch(
            self.hw, em=self.em,
            c_sa=conv[:, 0], c_simd=simd[:, 0], l_total=cycles,
            sram_bits={"wbuf": conv[:, 1], "ibuf": conv[:, 2],
                       "obuf": conv[:, 3], "bbuf": conv[:, 4],
                       "vmem": simd[:, 1]},
            sram_sizes={"wbuf": sizes[:, 0] * KB, "ibuf": sizes[:, 1] * KB,
                        "obuf": sizes[:, 2] * KB, "bbuf": self.hw.bbuf,
                        "vmem": sizes[:, 3] * KB},
            dram_bits=conv[:, 5] + simd[:, 2])

    def energy_at(self, name: str, point: DSEPoint) -> Dict[str, float]:
        """Energy report of one evaluated point (components are memoized
        by construction for every archived candidate)."""
        cand = (point.sizes_kb, point.bws)
        rep = self._energy_batch(name, [cand],
                                 np.array([point.cycles], dtype=np.int64))
        return {k: float(v[0]) for k, v in rep.items()}

    def energy_many(self, name: str,
                    points: Sequence[DSEPoint]) -> np.ndarray:
        """E_total for many evaluated points in one vectorized call (the
        Pareto path over the whole archive)."""
        cands = [(p.sizes_kb, p.bws) for p in points]
        cycles = np.array([p.cycles for p in points], dtype=np.int64)
        return self._energy_batch(name, cands, cycles)["E_total"]

    def evaluate(self, name: str, cands: Sequence[Cand]) -> np.ndarray:
        """Objective scores for each candidate (int64 cycles under the
        default cycles objective); one batched reduction per unique size
        triple / VMem value not already memoized.  Every newly seen
        candidate is archived (with its true cycle count) along with its
        score."""
        conv_memo, simd_memo = self._conv[name], self._simd[name]
        need_c: Dict[tuple, List[tuple]] = {}
        need_s: Dict[int, List[int]] = {}
        for sz, bw in cands:
            s3, b3 = sz[:3], bw[:3]
            if (s3, b3) not in conv_memo:
                lst = need_c.setdefault(s3, [])
                if b3 not in lst:
                    lst.append(b3)
            vm, wv = sz[3], bw[3]
            if (vm, wv) not in simd_memo:
                lst = need_s.setdefault(vm, [])
                if wv not in lst:
                    lst.append(wv)
        if need_c:
            self._conv_fill(name, need_c)
        if need_s:
            self._simd_fill(name, need_s)
        cycles = np.empty(len(cands), dtype=np.int64)
        for i, (sz, bw) in enumerate(cands):
            cycles[i] = conv_memo[(sz[:3], bw[:3])] \
                + simd_memo[(sz[3], bw[3])]
        if type(self.obj) is Cycles:   # exact type: custom "cycles"-named
            scores = cycles            # objectives still score() below
        else:
            mb = MetricBatch(cycles,
                             lambda: self._energy_batch(name, cands, cycles))
            scores = np.asarray(self.obj.score(mb), dtype=float)
        seen = self._seen[name]
        arch, arch_scores = self.archive[name], self.archive_scores[name]
        for i, (sz, bw) in enumerate(cands):
            if (sz, bw) not in seen:
                seen.add((sz, bw))
                arch.append(DSEPoint(sz, bw, int(cycles[i])))
                arch_scores.append(scores[i].item())
        return scores

    def cycles_of(self, name: str, cand: Cand) -> int:
        """True cycle count of an already-memoized candidate."""
        sz, bw = cand
        return (self._conv[name][(sz[:3], bw[:3])]
                + self._simd[name][(sz[3], bw[3])])

    def phase_cycles(self, name: str, point: DSEPoint) -> Dict[str, int]:
        """Phase-resolved cycles of any (sizes, bws) point — the same
        column-partition sums as the grid's per-phase matrices, driven at
        one configuration, so they partition the point's total exactly."""
        sz, bw = point.sizes_kb, point.bws
        out: Dict[str, int] = {}
        hw = self.hw.replace(wbuf=sz[0] * KB, ibuf=sz[1] * KB,
                             obuf=sz[2] * KB)
        pcols = self.eng.conv_phase_cols[name]
        if pcols:
            table = get_conv_table(hw, self.eng._conv_union)
            per_layer = table.layer_cycles_batch([bw[0]], [bw[1]], [bw[2]])
            for ph, cols in pcols.items():
                out[ph] = int(per_layer[:, cols].sum(axis=1)
                              .astype(np.int64)[0])
        gpcols = self.eng.gemm_phase_cols[name]
        if gpcols:
            table = get_gemm_table(hw, self.eng._gemm_union)
            per_layer = table.layer_cycles_batch([bw[0]], [bw[1]], [bw[2]])
            for ph, cols in gpcols.items():
                out[ph] = int(per_layer[:, cols].sum(axis=1)
                              .astype(np.int64)[0])
        pids = self.eng.simd_phase_ids[name]
        if pids:
            table = get_simd_table(self.hw.replace(vmem=sz[3] * KB),
                                   self.eng._simd_union)
            stall = table.row_stall_batch([bw[3]])
            for ph, ids in pids.items():
                rows = [r for i in ids for r in range(*table.layer_rows[i])]
                compute = sum(table.layer_compute[i] for i in ids)
                out[ph] = int((compute + stall[:, rows].sum(axis=1))
                              .astype(np.int64)[0])
        return out


# ---------------------------------------------------------------------------
# Feasible-tuple construction
# ---------------------------------------------------------------------------

def _ladder_move(tup: Tup, i: int, values: Sequence[int], up: bool
                 ) -> Optional[Tup]:
    """Move coordinate i one notch along the sorted value ladder."""
    vals = values
    pos = np.searchsorted(vals, tup[i])
    if up:
        if pos + 1 >= len(vals) or vals[pos] != tup[i]:
            return None
        nv = vals[pos + 1]
    else:
        if pos == 0 or vals[pos] != tup[i]:
            return None
        nv = vals[pos - 1]
    out = list(tup)
    out[i] = int(nv)
    return tuple(out)


def _repair(tup: Tup, values: Sequence[int], lo: float, hi: float
            ) -> Optional[Tup]:
    """Notch coordinates along the ladder until the sum lands in
    [lo, hi]; deterministic (largest coord down / smallest coord up,
    lowest index on ties).  None if the band is unreachable."""
    cur = tup
    for _ in range(64):
        s = sum(cur)
        if lo <= s <= hi:
            return cur
        if s > hi:
            order = sorted(range(4), key=lambda i: (-cur[i], i))
            moved = None
            for i in order:
                moved = _ladder_move(cur, i, values, up=False)
                if moved is not None:
                    break
        else:
            order = sorted(range(4), key=lambda i: (cur[i], i))
            moved = None
            for i in order:
                moved = _ladder_move(cur, i, values, up=True)
                if moved is not None:
                    break
        if moved is None:
            return None
        cur = moved
    return None


def _nearest(values: Sequence[int], target: float) -> int:
    return int(min(values, key=lambda v: (abs(v - target), v)))


def _starts(rng: np.random.Generator, values: Sequence[int], budget: int,
            lo: float, hi: float, n: int) -> List[Tup]:
    """Deterministic heuristic splits of the budget, then seeded random
    lattice tuples, all repaired into the band."""
    profiles = [
        (0.25, 0.25, 0.25, 0.25),      # balanced
        (0.30, 0.30, 0.30, 0.10),      # conv-side heavy
        (0.15, 0.15, 0.15, 0.55),      # vmem / last-coordinate heavy
    ]
    out: List[Tup] = []
    for prof in profiles:
        t = tuple(_nearest(values, f * budget) for f in prof)
        r = _repair(t, values, lo, hi)
        if r is not None and r not in out:
            out.append(r)
    guard = 0
    while len(out) < n and guard < 200:
        guard += 1
        t = tuple(int(values[k]) for k in rng.integers(0, len(values), 4))
        r = _repair(t, values, lo, hi)
        if r is not None and r not in out:
            out.append(r)
    return out[:n]


# ---------------------------------------------------------------------------
# Neighborhoods
# ---------------------------------------------------------------------------

def _lattice_neighbors(tup: Tup, values: Sequence[int], lo: float, hi: float
                       ) -> List[Tup]:
    """Level 0: every single-coordinate replacement by any other lattice
    value, pairwise transfers of up to three notches each way (multi-notch
    transfers cross valleys whose one-notch intermediates are uphill), and
    pairwise value swaps (sum-preserving by construction)."""
    out = set()
    for i in range(4):
        for v in values:
            if v == tup[i]:
                continue
            cand = list(tup)
            cand[i] = int(v)
            if lo <= sum(cand) <= hi:
                out.add(tuple(cand))
    for i in range(4):
        upi = tup
        for _ in range(3):
            upi = _ladder_move(upi, i, values, up=True)
            if upi is None:
                break
            for j in range(4):
                if j == i:
                    continue
                dnj = upi
                for _ in range(3):
                    dnj = _ladder_move(dnj, j, values, up=False)
                    if dnj is None:
                        break
                    if lo <= sum(dnj) <= hi:
                        out.add(dnj)
    for i in range(4):
        for j in range(i + 1, 4):
            if tup[i] != tup[j]:
                cand = list(tup)
                cand[i], cand[j] = cand[j], cand[i]
                out.add(tuple(cand))
    out.discard(tup)
    return sorted(out)


def _grow_repair_lattice(tup: Tup, i: int, notches: int,
                         values: Sequence[int], lo: float, hi: float
                         ) -> Optional[Tup]:
    """Grow coordinate i by ``notches`` ladder steps, then pay for it by
    notching the *smallest* other coordinates down until the sum is back
    in [lo, hi].  Smallest-first repair deliberately complements
    ``_repair``'s largest-first policy: it concentrates the budget on
    the grown coordinate instead of leveling the split."""
    cur: Optional[Tup] = tup
    for _ in range(notches):
        cur = _ladder_move(cur, i, values, up=True)
        if cur is None:
            return None
    for _ in range(64):
        s = sum(cur)
        if s <= hi:
            return cur if lo <= s else None
        moved = None
        for j in sorted((j for j in range(4) if j != i),
                        key=lambda j: (cur[j], j)):
            moved = _ladder_move(cur, j, values, up=False)
            if moved is not None:
                break
        if moved is None:
            return None
        cur = moved
    return None


def _grow_repair_step(tup: Tup, i: int, grow: int, step: int,
                      vmin: int, vmax: int, lo: float, hi: float
                      ) -> Optional[Tup]:
    """Arithmetic ``_grow_repair_lattice``: add ``grow`` to coordinate i
    (clamped to vmax), repair smallest-first in ``step`` decrements."""
    if tup[i] + grow > vmax:
        return None
    cur = list(tup)
    cur[i] += grow
    for _ in range(64):
        s = sum(cur)
        if s <= hi:
            return tuple(cur) if lo <= s else None
        js = [j for j in range(4) if j != i and cur[j] - step >= vmin]
        if not js:
            return None
        j = min(js, key=lambda j: (cur[j], j))
        cur[j] -= step
    return None


def _joint_moves(sizes_tup: Tup, bws_tup: Tup,
                 s_grow, b_grow) -> List[Cand]:
    """Paired size+bandwidth moves: grow buffer i *and* its feed
    bandwidth together, each paid for by the smallest other coordinates.
    Coordinate descent over sizes-only / bws-only neighborhoods misses
    optima where a buffer and its bandwidth must move as one (a bigger
    IBuf only pays once the input stream is also fed faster — each
    single-axis move is uphill, the pair is downhill; observed on the
    16x16 training fixture).  ``s_grow(i, n)`` / ``b_grow(i, n)`` map a
    coordinate and a grow amount to a repaired tuple or None."""
    out: List[Cand] = []
    for i in range(4):
        ss = [s for n in (1, 2, 3)
              for s in [s_grow(i, n)] if s is not None]
        bs = [b for n in (1, 2, 3)
              for b in [b_grow(i, n)] if b is not None]
        for s in ss:
            if s == sizes_tup:
                continue
            for b in bs:
                if b != bws_tup:
                    out.append((s, b))
    return out


def _step_neighbors(tup: Tup, step: int, vmin: int, vmax: int,
                    lo: float, hi: float) -> List[Tup]:
    """Refinement levels: single-coordinate +-{1,2,4}*step moves plus
    pairwise +-step transfers, clamped to [vmin, vmax] and the band."""
    out = set()
    for i in range(4):
        for k in (1, 2, 4):
            for d in (k * step, -k * step):
                nv = tup[i] + d
                if not vmin <= nv <= vmax:
                    continue
                cand = list(tup)
                cand[i] = nv
                if lo <= sum(cand) <= hi:
                    out.add(tuple(cand))
    for i in range(4):
        for j in range(4):
            if i == j:
                continue
            ni, nj = tup[i] + step, tup[j] - step
            if not (vmin <= ni <= vmax and vmin <= nj <= vmax):
                continue
            cand = list(tup)
            cand[i], cand[j] = ni, nj
            if lo <= sum(cand) <= hi:
                out.add(tuple(cand))
    return sorted(out)


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------

def _min_gap(values: Sequence[int]) -> int:
    vs = sorted(set(values))
    return min(b - a for a, b in zip(vs, vs[1:])) if len(vs) > 1 else 1


def refine_search_many(hw_base: HardwareSpec,
                       nets: Mapping[str, Sequence[object]],
                       size_budget_kb: int, bw_budget: int, *,
                       sizes: Sequence[int], bws: Sequence[int],
                       tol: float, lower_bound: bool,
                       refine: Optional[RefineConfig] = None,
                       objective: Optional[Objective] = None,
                       em: EnergyModel = DEFAULT_ENERGY,
                       workers: int = 0) -> Dict[str, DSEResult]:
    """The ``method="refine"`` front-end (see module docstring).

    It takes neither ``backend`` nor ``device``, so a ``Study`` forwards
    neither: the local search prices small scalar neighborhoods on the
    host's numpy tables, on any study, as the JAX package's does — the
    torch backends (``repro_torch.core.gridtorch``) pay off on
    whole-lattice reductions.

    Networks are optimized independently but share the union cost tables
    and the process-lifetime table cache, exactly like the grid engine —
    so a refine run after (or before) a grid sweep of the same shapes
    rebuilds nothing at the lattice level.  The descent accepts moves on
    the ``objective``'s score (cycles by default; energy/EDP/power-capped
    searches run the identical search dynamics over their own
    landscape)."""
    cfg = refine if refine is not None else RefineConfig()
    sizes = sorted(int(s) for s in sizes)
    bws = sorted(int(b) for b in bws)
    lo_s = size_budget_kb * (1 - tol) if lower_bound else 0
    lo_b = bw_budget * (1 - tol) if lower_bound else 0
    hi_s = size_budget_kb * (1 + tol)
    hi_b = bw_budget * (1 + tol)
    n_grid = (len(_tuples(sizes, 4, lo_s, hi_s))
              * len(_tuples(bws, 4, lo_b, hi_b)))
    if n_grid == 0:
        raise ValueError("empty DSE space; widen grids or budgets")
    # The default budget scales with the grid so the Table VIII fixtures
    # stay an order of magnitude under exhaustive, with a floor that lets
    # every start finish on small grids (where no saving is claimed).
    max_evals = cfg.max_evals if cfg.max_evals is not None \
        else max(600, n_grid // 12)

    ev = _RefineEvaluator(hw_base, nets, objective=objective, em=em,
                          workers=workers)
    out: Dict[str, DSEResult] = {}
    for name in nets:
        out[name] = _refine_one(ev, name, cfg, sizes, bws,
                                size_budget_kb, bw_budget,
                                (lo_s, hi_s), (lo_b, hi_b),
                                max_evals, n_grid)
    return out


def _refine_one(ev: _RefineEvaluator, name: str, cfg: RefineConfig,
                sizes: Sequence[int], bws: Sequence[int],
                size_budget_kb: int, bw_budget: int,
                s_band: Tuple[float, float], b_band: Tuple[float, float],
                max_evals: int, n_grid: int) -> DSEResult:
    rng = np.random.default_rng(cfg.seed)
    s_starts = _starts(rng, sizes, size_budget_kb,
                       s_band[0], s_band[1], cfg.n_starts)
    b_starts = _starts(rng, bws, bw_budget,
                       b_band[0], b_band[1], cfg.n_starts)
    starts: List[Cand] = [
        (s_starts[k % len(s_starts)], b_starts[k % len(b_starts)])
        for k in range(max(len(s_starts), len(b_starts)))
    ] if s_starts and b_starts else []
    if not starts:
        raise ValueError("no feasible starting point in the budget band")

    steps: List[int] = []
    if not cfg.lattice_only:
        st = _min_gap(sizes + list(bws)) // 2
        while st >= max(1, cfg.min_step):
            steps.append(st)
            st //= 2
    vmin_s, vmax_s = min(sizes), max(sizes)
    vmin_b, vmax_b = min(bws), max(bws)

    trajectory: List[Tuple[int, int, DSEPoint]] = []

    for si, start in enumerate(starts):
        if ev.n_evals(name) >= max_evals:
            break
        cur = start
        cur_score = ev.evaluate(name, [cur])[0].item()
        trajectory.append(
            (si, 0, DSEPoint(cur[0], cur[1], ev.cycles_of(name, cur))))
        level = 0                     # 0 = lattice, k>=1 = steps[k-1]
        moves = 0
        while moves < cfg.max_steps:
            if level == 0:
                s_nb = _lattice_neighbors(cur[0], sizes, *s_band)
                b_nb = _lattice_neighbors(cur[1], bws, *b_band)
                joint = _joint_moves(
                    cur[0], cur[1],
                    lambda i, n: _grow_repair_lattice(cur[0], i, n,
                                                      sizes, *s_band),
                    lambda i, n: _grow_repair_lattice(cur[1], i, n,
                                                      bws, *b_band))
                stride = 0
            else:
                stp = steps[level - 1]
                s_nb = _step_neighbors(cur[0], stp, vmin_s, vmax_s, *s_band)
                b_nb = _step_neighbors(cur[1], stp, vmin_b, vmax_b, *b_band)
                joint = _joint_moves(
                    cur[0], cur[1],
                    lambda i, n: _grow_repair_step(cur[0], i, n * stp, stp,
                                                   vmin_s, vmax_s, *s_band),
                    lambda i, n: _grow_repair_step(cur[1], i, n * stp, stp,
                                                   vmin_b, vmax_b, *b_band))
                stride = stp
            cands = sorted({(s, cur[1]) for s in s_nb}
                           | {(cur[0], b) for b in b_nb}
                           | set(joint))
            room = max_evals - ev.n_evals(name)
            if cands and room > 0:
                cands = ev.filter_budget(name, cands, room)
                scores = ev.evaluate(name, cands)
                i = int(scores.argmin())         # first occurrence: the
                cand, score = cands[i], scores[i].item()  # order-earliest min
            else:
                cand, score = None, None
            # accept a strictly better score, or an equal score at a point
            # earlier in (sizes, bws) tuple order — the legacy grid
            # iteration order for ascending lattices; the monotone
            # decrease also guarantees termination
            if cand is not None and (score, cand) < (cur_score, cur):
                cur, cur_score = cand, score
                moves += 1
                trajectory.append(
                    (si, stride,
                     DSEPoint(cur[0], cur[1], ev.cycles_of(name, cur))))
                level = 0             # improvement: restart from coarse
            else:
                level += 1            # stalled: refine the stride
                if level > len(steps):
                    break

    arch = ev.archive[name]
    arch_scores = ev.archive_scores[name]
    is_cycles = type(ev.obj) is Cycles
    scored = [(s, p) for s, p in zip(arch_scores, arch)
              if s != float("inf")]
    if not scored:
        raise ValueError(f"objective {ev.obj.name!r} marks every evaluated "
                         f"candidate infeasible for network {name!r}")
    best_point = min(scored, key=lambda sp: (sp[0], sp[1].sizes_kb,
                                             sp[1].bws))[1]
    worst_point = max(scored, key=lambda sp: (sp[0], sp[1].sizes_kb,
                                              sp[1].bws))[1]
    trace = RefineTrace(seed=cfg.seed, n_starts=len(starts),
                        n_evals=ev.n_evals(name),
                        n_size_triples=ev.n_size_triples(name),
                        n_vmems=ev.n_vmems(name),
                        grid_candidates=n_grid,
                        trajectory=tuple(trajectory))
    return DSEResult(best=best_point, worst=worst_point,
                     refine=trace, archive=list(arch),
                     objective=ev.obj.name,
                     archive_scores=None if is_cycles else list(arch_scores),
                     _phase_at=lambda p, _n=name: ev.phase_cycles(_n, p),
                     _energy_at=lambda p, _n=name: ev.energy_at(_n, p),
                     _energy_many=lambda ps, _n=name: ev.energy_many(_n, ps))


register_search_method("refine", refine_search_many)

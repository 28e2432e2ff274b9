"""On-device DSE grid evaluation — the torch backend of the grid front-end.

The counterpart of the JAX package's ``core/gridax.py``.  The exhaustive
search is two separable cost matrices plus a handful of reductions: an
outer add routed through the ``s3_of``/``b3_of``/``v_of``/``w_of``
projections, argmin/argmax for best/worst, the within-frac frontier mask,
objective scoring over the grid, and the 2-D Pareto mask.  This module
runs them in torch on an explicit ``torch.device`` — plain torch ops for
the general path, and the hand-written CUDA grid min/max kernel
(``repro_torch.kernels.reduce``) for the hot cycles-only best/worst —
selected per search via ``Study(backend="torch")`` /
``Study(backend="torch-fused")`` or ``$REPRO_DSE_BACKEND``.

Bit-identity contract (pinned against the numpy engine, the scalar
``search_reference`` and the JAX package's ``gridax``):

  * **int64 cycles.**  Tables go to the device as int64
    (``from_numpy_tables``); torch has no int32 default to guard against.
  * **Float promotion.**  torch promotes ``int64_tensor <= python_float``
    and ``int64_tensor * python_float`` to float32, numpy to float64.
    Every frontier and within comparison therefore casts both sides to
    float64 explicitly: training cycles near 1.7e10 differ in float32.
  * **First-occurrence ties.**  ``torch.argmin``/``argmax`` return the
    first occurrence, as numpy's do; the CUDA kernel merges
    lexicographically on (value, flat index) for the same contract.
  * **Scoring on the device.**  General objectives score the
    device-composed cost grid where it lies: ``energy.array_namespace``
    gives a torch namespace for a tensor, and the energy report and the
    shipped objectives are eager float64 torch ops, the same IEEE
    operations in the same order as the numpy engine (no op that fuses a
    multiply into an add, no division by a Python scalar).  The masked
    best/worst and the frontier follow on the device.

Results return as numpy arrays: the ``DSEGrid``/``DSEResult`` machinery
downstream is shared with the numpy backend.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.reduce import grid_minmax


def resolve_device(device) -> torch.device:
    """``None`` or a name/``torch.device`` -> ``torch.device`` (``None``
    means ``"cuda"``).  Asking for CUDA without one raises: the port runs
    on the CPU only when the caller says ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the DSE reductions run on CUDA by default, and "
            "torch.cuda.is_available() is false; pass device='cpu' to "
            "run them on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    return dev


@dataclass(eq=False)
class GridTables:
    """The data one grid reduction consumes, on the device: stacked cost
    matrices of N networks that share one candidate space, and the four
    candidate projections into them.  All contiguous int64."""
    conv: torch.Tensor           # [N, n_size_triples, n_bw_triples]
    simd: torch.Tensor           # [N, n_vmem, n_bw_v]
    s3_of: torch.Tensor          # [n_size_tuples] -> conv row
    b3_of: torch.Tensor          # [n_bw_tuples]   -> conv column
    v_of: torch.Tensor           # [n_size_tuples] -> simd row
    w_of: torch.Tensor           # [n_bw_tuples]   -> simd column

    def panels(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Column-pre-gathered operand panels, [N, n_s3, n_bw] and
        [N, n_v, n_bw] (the JAX package's ``_gather_panels_impl``)."""
        return (self.conv.index_select(2, self.b3_of),
                self.simd.index_select(2, self.w_of))

    def costs(self, panels=None) -> torch.Tensor:
        """The composed cost grids, [N, n_size_tuples, n_bw_tuples], from
        ``panels`` if the caller already gathered them."""
        conv, simd = self.panels() if panels is None else panels
        return conv.index_select(1, self.s3_of) \
            + simd.index_select(1, self.v_of)


def from_numpy_tables(conv_mats: Sequence[np.ndarray],
                      simd_mats: Sequence[np.ndarray],
                      s3_of: np.ndarray, b3_of: np.ndarray,
                      v_of: np.ndarray, w_of: np.ndarray,
                      device) -> GridTables:
    """Move the host cost matrices (one per network, stacked) and the
    projections to ``device`` as contiguous int64 tensors.  Projections
    stay int64 (``dse._project`` gives ``np.intp``); each is checked on
    the host to index inside its matrix, so no kernel reads out of
    bounds."""
    device = torch.device(device)
    conv = np.stack([np.asarray(m, dtype=np.int64) for m in conv_mats])
    simd = np.stack([np.asarray(m, dtype=np.int64) for m in simd_mats])
    proj = {}
    for name, p, bound in (("s3_of", s3_of, conv.shape[1]),
                           ("b3_of", b3_of, conv.shape[2]),
                           ("v_of", v_of, simd.shape[1]),
                           ("w_of", w_of, simd.shape[2])):
        p = np.ascontiguousarray(p, dtype=np.int64)
        if p.ndim != 1 or (p.size and (p.min() < 0 or p.max() >= bound)):
            raise ValueError(f"{name} must be a 1-D projection into "
                             f"[0, {bound})")
        proj[name] = torch.from_numpy(p).to(device)
    if proj["s3_of"].shape != proj["v_of"].shape \
            or proj["b3_of"].shape != proj["w_of"].shape:
        raise ValueError("size projections (s3_of, v_of) and bandwidth "
                         "projections (b3_of, w_of) must pair up")
    return GridTables(conv=torch.from_numpy(conv).to(device),
                      simd=torch.from_numpy(simd).to(device), **proj)


def _frontier(flat: torch.Tensor, best: torch.Tensor,
              mult: float) -> torch.Tensor:
    """``flat <= flat[best] * mult`` along the last axis, promoted as
    numpy promotes it: both sides float64."""
    f = flat.to(torch.float64)
    return f <= f.gather(-1, best.unsqueeze(-1)) * mult


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class HostReadable(torch.Tensor):
    """A tensor that numpy reads by copying it to the host, as it reads a
    jax array: what a ``MetricBatch`` of the torch backends hands an
    objective, so that a numpy-only objective (``np.asarray(m.cycles)``)
    keeps working on a CUDA grid.  Torch ops on it stay on its device."""

    def __array__(self, dtype=None, copy=None):
        a = _host(self.as_subclass(torch.Tensor).detach())
        return a if dtype is None else a.astype(dtype, copy=False)


def _readable(x):
    return x.as_subclass(HostReadable) if isinstance(x, torch.Tensor) else x


def _plain_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return _host(x.as_subclass(torch.Tensor))
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Public entry points (numpy in, numpy out)
# ---------------------------------------------------------------------------

def outer_add(conv: np.ndarray, simd: np.ndarray,
              s3_of: np.ndarray, b3_of: np.ndarray,
              v_of: np.ndarray, w_of: np.ndarray, *, device) -> np.ndarray:
    """The device outer-add composition — int64-exact equivalent of
    ``conv[np.ix_(s3_of, b3_of)] + simd[np.ix_(v_of, w_of)]``."""
    t = from_numpy_tables([conv], [simd], s3_of, b3_of, v_of, w_of, device)
    return _host(t.costs()[0])


def fused_minmax(conv: np.ndarray, simd: np.ndarray,
                 s3_of: np.ndarray, b3_of: np.ndarray,
                 v_of: np.ndarray, w_of: np.ndarray, *,
                 device) -> Tuple[int, int]:
    """(argmin, argmax) flat indices of the virtual cost grid through
    ``grid_minmax`` — the grid itself is never materialised: columns are
    pre-gathered into two operand panels, rows are gathered inside the
    kernel."""
    t = from_numpy_tables([conv], [simd], s3_of, b3_of, v_of, w_of, device)
    cb, sb = t.panels()
    out = _host(grid_minmax(cb[0], sb[0], t.s3_of, t.v_of))
    return int(out[1]), int(out[3])


def reduce_cycles_many(convs: Sequence[np.ndarray],
                       simds: Sequence[np.ndarray],
                       s3_of: np.ndarray, b3_of: np.ndarray,
                       v_of: np.ndarray, w_of: np.ndarray, *,
                       frontier_mult: float, fused: bool = False,
                       device) -> List[Tuple[np.ndarray, int, int,
                                             np.ndarray]]:
    """The cycles-objective reduction for N networks sharing one
    candidate space: per network ``(costs, best_idx, worst_idx,
    frontier_mask)`` with ``frontier_mask = costs <= best*frontier_mult``
    (flat).  The N networks run as one batched gather over the stacked
    matrices; ``fused`` routes best/worst through the CUDA kernel
    (``grid_minmax``, one launch per network) instead of torch's
    argmin/argmax."""
    t = from_numpy_tables(convs, simds, s3_of, b3_of, v_of, w_of, device)
    cb, sb = t.panels()
    costs = t.costs((cb, sb))
    flat = costs.reshape(costs.shape[0], -1)
    if fused:
        mm = torch.stack([grid_minmax(cb[n], sb[n], t.s3_of, t.v_of)
                          for n in range(cb.shape[0])])
        bi, wi = mm[:, 1], mm[:, 3]
    else:
        bi, wi = flat.argmin(dim=1), flat.argmax(dim=1)
    fm = _frontier(flat, bi, frontier_mult)
    costs, bi, wi, fm = _host(costs), _host(bi), _host(wi), _host(fm)
    return [(costs[n], int(bi[n]), int(wi[n]), fm[n])
            for n in range(costs.shape[0])]


def reduce_scored(conv: np.ndarray, simd: np.ndarray,
                  s3_of: np.ndarray, b3_of: np.ndarray,
                  v_of: np.ndarray, w_of: np.ndarray, *,
                  objective, energy_grids_fn: Callable, frontier_mult: float,
                  device) -> Tuple[np.ndarray, np.ndarray,
                                   Optional[Dict[str, np.ndarray]],
                                   int, int, bool, np.ndarray]:
    """The general-objective reduction for one network: compose the cost
    grid on the device, score it there through ``objective`` (energy
    grids, if the objective pulls them, come from
    ``energy_grids_fn(costs)`` on the device tensor -- the torch-aware
    ``compute_energy_batch`` keeps them there), then the
    non-finite-masked best/worst and the frontier mask.  The objective
    sees ``HostReadable`` tensors; a numpy score is taken back to the
    device.

    Returns ``(costs, scores, energy_report_or_None, best_idx,
    worst_idx, any_feasible, frontier_mask)`` — all numpy."""
    from .objectives import MetricBatch
    t = from_numpy_tables([conv], [simd], s3_of, b3_of, v_of, w_of, device)
    costs = t.costs()[0]
    mb = MetricBatch(_readable(costs), lambda: {
        k: _readable(v) for k, v in energy_grids_fn(costs).items()})
    scores = objective.score(mb)
    if not isinstance(scores, torch.Tensor):     # numpy's own conversion
        scores = np.ascontiguousarray(scores, dtype=float)
    scores = torch.as_tensor(scores, dtype=torch.float64,
                             device=device).as_subclass(torch.Tensor)
    flat = scores.reshape(-1)
    finite = torch.isfinite(flat)
    # mask both sides: a NaN (or +-inf) score marks an infeasible
    # candidate and must poison neither argmin nor argmax
    bi = torch.where(finite, flat, float("inf")).argmin()
    wi = torch.where(finite, flat, float("-inf")).argmax()
    fm = _frontier(flat, bi, frontier_mult)
    report = None if mb._report is None else \
        {k: _plain_host(v) for k, v in mb._report.items()}
    return (_host(costs), _host(scores), report, int(bi), int(wi),
            bool(finite.any()), _host(fm))


def within_mask(values: np.ndarray, limit: float, *, device) -> np.ndarray:
    """Flat boolean mask ``values <= limit`` computed on the device, with
    numpy's promotion (int64 values and a float limit compare in
    float64)."""
    values = np.asarray(values)
    dtype = np.result_type(values.dtype, float(limit))
    v = torch.from_numpy(np.ascontiguousarray(values).ravel()).to(device)
    return _host(v.to(getattr(torch, dtype.name))
                 <= torch.tensor(float(limit), dtype=getattr(torch, dtype.name),
                                 device=device))


def pareto_mask(cycles: np.ndarray, energy: np.ndarray, *,
                device) -> np.ndarray:
    """Device analogue of ``dse._pareto_mask`` — bit-identical, but
    vectorized (the numpy version is a sequential Python walk).

    Two stable sorts, energy then cycles, starting from index order,
    give the order of ``np.lexsort((index, energy, cycles))``.  In that
    order the walk keeps an element iff its energy is strictly below the
    running minimum over kept predecessors — which equals the minimum
    over all predecessors, since any element that lowered the minimum
    was itself kept — so an exclusive prefix-min reproduces it.  NaN
    energies sort last, are never kept and never lower the minimum, so
    they enter the prefix-min as +inf."""
    c = torch.from_numpy(np.ascontiguousarray(cycles).ravel()).to(device)
    e = torch.from_numpy(
        np.ascontiguousarray(energy, dtype=float).ravel()).to(device)
    n = c.shape[0]
    if n == 0:
        return np.zeros(0, dtype=bool)
    order = torch.sort(e, stable=True).indices
    order = order[torch.sort(c[order], stable=True).indices]
    e_sorted = e[order]
    inf = torch.full((1,), float("inf"), dtype=e.dtype, device=e.device)
    run_min = torch.cummin(
        torch.where(torch.isnan(e_sorted), inf, e_sorted), dim=0).values
    keep_sorted = e_sorted < torch.cat([inf, run_min[:-1]])
    keep = torch.zeros(n, dtype=torch.bool, device=e.device)
    keep[order] = keep_sorted
    return _host(keep)

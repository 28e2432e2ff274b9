"""Each ``repro_torch.core.gridtorch`` function against its ``gridax``
counterpart in the JAX package (and the numpy engine), on the CPU.

Inputs are made from a seed with numpy and handed to both packages; every
comparison is exact (int64 and float64 bitwise equal, masks and indices
equal).  The cases include int64 cost grids past 2**31, a within/frontier
comparison that float32 promotion would get wrong, Pareto sets with
duplicate points and NaN energies, and NaN scores on both extremes.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _jax_reference import MODULES, jax_grid  # noqa: E402,F401

from repro.core.dse import _pareto_mask as ref_pareto_mask  # noqa: E402
from repro_torch.core import gridtorch  # noqa: E402
from repro_torch.core.dse import _pareto_mask as port_pareto_mask  # noqa: E402

CPU = torch.device("cpu")
MULT = 1.15


def _tables(seed, n_net=1, n_s3=6, n_b3=5, n_v=3, n_w=4, n_size=13,
            n_bw=11, lo=2 ** 31, hi=2 ** 34):
    rng = np.random.default_rng(seed)
    convs = [rng.integers(lo, hi, size=(n_s3, n_b3), dtype=np.int64)
             for _ in range(n_net)]
    simds = [rng.integers(lo, hi, size=(n_v, n_w), dtype=np.int64)
             for _ in range(n_net)]
    proj = (rng.integers(0, n_s3, n_size), rng.integers(0, n_b3, n_bw),
            rng.integers(0, n_v, n_size), rng.integers(0, n_w, n_bw))
    return convs, simds, tuple(p.astype(np.intp) for p in proj)


def _numpy_costs(conv, simd, s3_of, b3_of, v_of, w_of):
    return conv[np.ix_(s3_of, b3_of)] + simd[np.ix_(v_of, w_of)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_outer_add(jax_grid, seed):
    gridax, _ = jax_grid
    (conv,), (simd,), proj = _tables(seed)
    got = gridtorch.outer_add(conv, simd, *proj, device=CPU)
    assert got.dtype == np.int64 and got.max() > 2 ** 31
    np.testing.assert_array_equal(got, _numpy_costs(conv, simd, *proj))
    np.testing.assert_array_equal(got, gridax.outer_add(conv, simd, *proj))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_minmax(jax_grid, seed):
    gridax, _ = jax_grid
    (conv,), (simd,), proj = _tables(seed)
    flat = _numpy_costs(conv, simd, *proj).ravel()
    got = gridtorch.fused_minmax(conv, simd, *proj, device=CPU)
    assert got == (int(flat.argmin()), int(flat.argmax()))
    assert got == gridax.fused_minmax(conv, simd, *proj, interpret=True)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n_net", [1, 3])
def test_reduce_cycles_many(jax_grid, fused, n_net):
    gridax, _ = jax_grid
    convs, simds, proj = _tables(10 + n_net, n_net=n_net, lo=2 ** 33,
                                 hi=2 ** 33 + 2 ** 31)
    got = gridtorch.reduce_cycles_many(convs, simds, *proj,
                                       frontier_mult=MULT, fused=fused,
                                       device=CPU)
    want = gridax.reduce_cycles_many(convs, simds, *proj,
                                     frontier_mult=MULT, fused=fused,
                                     interpret=True)
    assert len(got) == len(want) == n_net
    for (c, bi, wi, fm), (jc, jbi, jwi, jfm), conv, simd in zip(
            got, want, convs, simds):
        costs = _numpy_costs(conv, simd, *proj)
        np.testing.assert_array_equal(c, costs)
        np.testing.assert_array_equal(c, jc)
        flat = costs.ravel()
        assert (bi, wi) == (int(flat.argmin()), int(flat.argmax())) \
            == (jbi, jwi)
        np.testing.assert_array_equal(fm, flat <= flat[bi] * MULT)
        np.testing.assert_array_equal(fm, jfm)
        assert fm.any() and not fm.all()


def _float32_trap():
    """A cost grid whose frontier float32 promotion gets wrong: best is
    2**34, and one entry lies just above best*1.15 in float64 but rounds
    onto the limit in float32."""
    best = 2 ** 34
    limit = best * MULT
    above = int(np.floor(limit)) + 1
    assert above > limit
    assert np.float32(above) <= np.float32(best) * np.float32(MULT)
    conv = np.array([[best, above, above + 10 ** 9]], dtype=np.int64)
    simd = np.zeros((1, 1), dtype=np.int64)
    proj = (np.array([0]), np.array([0, 1, 2]), np.array([0]),
            np.array([0, 0, 0]))
    return conv, simd, proj, above, limit


@pytest.mark.parametrize("fused", [False, True])
def test_frontier_is_float64_not_float32(jax_grid, fused):
    gridax, _ = jax_grid
    conv, simd, proj, _, _ = _float32_trap()
    ((c, bi, _, fm),) = gridtorch.reduce_cycles_many(
        [conv], [simd], *proj, frontier_mult=MULT, fused=fused, device=CPU)
    ((_, _, _, jfm),) = gridax.reduce_cycles_many(
        [conv], [simd], *proj, frontier_mult=MULT, fused=fused,
        interpret=True)
    np.testing.assert_array_equal(fm, [True, False, False])
    np.testing.assert_array_equal(fm, jfm)


def test_within_mask_is_float64_not_float32(jax_grid):
    gridax, _ = jax_grid
    _, _, _, above, limit = _float32_trap()
    values = np.array([[2 ** 34, above], [above - 2, above + 1]],
                      dtype=np.int64)
    got = gridtorch.within_mask(values, limit, device=CPU)
    want = values.ravel() <= limit
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, gridax.within_mask(values, limit))
    assert not got[1]


def test_within_mask_float_scores(jax_grid):
    gridax, _ = jax_grid
    rng = np.random.default_rng(7)
    scores = rng.random((9, 8))
    scores[2, 3] = np.nan
    scores[4, 4] = np.inf
    limit = float(np.nanmedian(scores))
    got = gridtorch.within_mask(scores, limit, device=CPU)
    np.testing.assert_array_equal(got, scores.ravel() <= limit)
    np.testing.assert_array_equal(got, gridax.within_mask(scores, limit))


class _NanEnds:
    """A duck-typed objective: cycles as float, with NaN on the grid's
    minimum and maximum cycle counts (and an inf elsewhere), so that an
    unmasked argmin/argmax would pick an infeasible candidate."""
    name = "nan_ends"

    def score(self, mb):
        c = np.asarray(mb.cycles, dtype=float)
        s = c.copy()
        s.flat[c.argmin()] = np.nan
        s.flat[c.argmax()] = np.nan
        s.flat[len(s.flat) // 2] = np.inf
        return s


class _EnergyPull:
    """Scores with the energy report, so the report round-trips."""
    name = "energy_pull"

    def score(self, mb):
        return np.asarray(mb.energy_report()["E_total"])


def _energy_fn(costs):
    c = np.asarray(costs, dtype=float)
    return {"E_total": c * 1e-9 + 0.25, "P_avg": c * 0 + 1.0}


@pytest.mark.parametrize("objective", [_NanEnds(), _EnergyPull()],
                         ids=lambda o: o.name)
def test_reduce_scored(jax_grid, objective):
    gridax, _ = jax_grid
    (conv,), (simd,), proj = _tables(21)
    got = gridtorch.reduce_scored(conv, simd, *proj, objective=objective,
                                  energy_grids_fn=_energy_fn,
                                  frontier_mult=MULT, device=CPU)
    want = gridax.reduce_scored(conv, simd, *proj, objective=objective,
                                energy_grids_fn=_energy_fn,
                                frontier_mult=MULT)
    costs, scores, report, bi, wi, feasible, fm = got
    np.testing.assert_array_equal(costs, want[0])
    assert scores.dtype == want[1].dtype == np.float64
    np.testing.assert_array_equal(scores, want[1])
    if report is None:
        assert want[2] is None
    else:
        assert report.keys() == want[2].keys()
        for k in report:
            np.testing.assert_array_equal(report[k], want[2][k])
    assert (bi, wi, feasible) == tuple(want[3:6])
    np.testing.assert_array_equal(fm, want[6])
    flat = scores.ravel()
    finite = np.isfinite(flat)
    assert bi == int(np.where(finite, flat, np.inf).argmin())
    assert wi == int(np.where(finite, flat, -np.inf).argmax())
    assert np.isfinite(flat[bi]) and np.isfinite(flat[wi])


def test_reduce_scored_all_infeasible():
    (conv,), (simd,), proj = _tables(22)

    class _Nothing:
        name = "nothing"

        def score(self, mb):
            return np.full(np.shape(mb.cycles), np.nan)
    out = gridtorch.reduce_scored(conv, simd, *proj, objective=_Nothing(),
                                  energy_grids_fn=_energy_fn,
                                  frontier_mult=MULT, device=CPU)
    assert out[5] is False


def _pareto_case(seed, n=300, nan=False):
    rng = np.random.default_rng(seed)
    cycles = rng.integers(2 ** 33, 2 ** 33 + 40, size=n, dtype=np.int64)
    energy = rng.integers(0, 30, size=n).astype(float) * 0.5
    dup = rng.integers(0, n, size=n // 5)
    cycles[dup[1:]] = cycles[dup[0]]           # duplicate (cycles, energy)
    energy[dup[1:]] = energy[dup[0]]
    if nan:
        energy[rng.integers(0, n, size=n // 10)] = np.nan
        energy[int(np.argmin(cycles))] = np.nan   # NaN at the fastest
    return cycles, energy


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pareto_mask_with_duplicates(jax_grid, seed):
    gridax, _ = jax_grid
    cycles, energy = _pareto_case(seed)
    got = gridtorch.pareto_mask(cycles, energy, device=CPU)
    np.testing.assert_array_equal(got, ref_pareto_mask(cycles, energy))
    np.testing.assert_array_equal(got, port_pareto_mask(cycles, energy))
    np.testing.assert_array_equal(got, gridax.pareto_mask(cycles, energy))
    assert got.sum() >= 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pareto_mask_with_nan_energies(seed):
    """NaN energies are never kept and never shadow a later point, as in
    the host walk ``dse._pareto_mask``.  (The JAX package's vectorized
    ``gridax.pareto_mask`` propagates NaN through its prefix-min and
    drops the points after it; the port holds the host walk.)"""
    cycles, energy = _pareto_case(seed, nan=True)
    got = gridtorch.pareto_mask(cycles, energy, device=CPU)
    np.testing.assert_array_equal(got, ref_pareto_mask(cycles, energy))
    assert not got[np.isnan(energy)].any()


def test_pareto_mask_float_cycles_and_empty():
    cycles = np.array([3.0, 1.0, 1.0, 2.0, np.inf])
    energy = np.array([1.0, 5.0, 5.0, 2.0, 0.5])
    np.testing.assert_array_equal(
        gridtorch.pareto_mask(cycles, energy, device=CPU),
        ref_pareto_mask(cycles, energy))
    assert gridtorch.pareto_mask(np.zeros(0), np.zeros(0),
                                 device=CPU).shape == (0,)


def test_from_numpy_tables_is_int64_and_checks_projections():
    convs, simds, proj = _tables(30, n_net=2)
    t = gridtorch.from_numpy_tables(convs, simds, *proj, device=CPU)
    for x in (t.conv, t.simd, t.s3_of, t.b3_of, t.v_of, t.w_of):
        assert x.dtype == torch.int64 and x.is_contiguous()
    assert tuple(t.conv.shape) == (2,) + convs[0].shape
    assert tuple(t.costs().shape) == (2, len(proj[0]), len(proj[1]))
    bad = (proj[0] + convs[0].shape[0],) + proj[1:]
    with pytest.raises(ValueError, match="s3_of"):
        gridtorch.from_numpy_tables(convs, simds, *bad, device=CPU)
    with pytest.raises(ValueError, match="pair up"):
        gridtorch.from_numpy_tables(convs, simds, proj[0][1:], *proj[1:],
                                    device=CPU)


def test_resolve_device():
    assert gridtorch.resolve_device("cpu") == CPU
    with pytest.raises(ValueError):
        gridtorch.resolve_device("meta")
    if not torch.cuda.is_available():
        for dev in (None, "cuda"):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                gridtorch.resolve_device(dev)


def test_jax_reference_shim_leaves_no_trace():
    """After ``jax_grid`` tears down, the JAX package's grid modules are
    gone and import as they do without the shim (on a jax that lacks
    ``jax.experimental.enable_x64``, they fail to import)."""
    import jax.experimental
    for name in MODULES:
        assert name not in sys.modules
    if hasattr(jax.experimental, "enable_x64"):
        pytest.skip("this jax still has jax.experimental.enable_x64")
    with pytest.raises(ImportError):
        import repro.core.gridax  # noqa: F401
    assert "repro.core.gridax" not in sys.modules
    assert "repro.kernels.reduce" not in sys.modules

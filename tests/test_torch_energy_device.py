"""The port's energy scoring on the device, on the CPU: the torch namespace
of ``energy.array_namespace``, ``compute_energy_batch`` over tensors,
``gridtorch.reduce_scored`` and the torch backends' general-objective
searches, each against the numpy engine and the JAX package's
``gridax.reduce_scored``.

Every comparison is bitwise (float64, and the same bits where a value is
not NaN): the device path must make the same IEEE operations in the same
order as numpy.  The grids hold zero-cycle candidates (``P_avg``'s 0
branch) and cycle counts past 2**31, up to 7.4e11 (gemma3-27b
training's grid on the 64x64 training preset).  Where ``gridax`` and
numpy disagree, numpy is the ground truth.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
import hypothesis.strategies as st  # noqa: E402
from hypothesis import given, settings  # noqa: E402

from _jax_reference import jax_grid  # noqa: E402,F401

from repro.core import INFER_PRESETS as REF_INFER  # noqa: E402
from repro.core import TRAIN_PRESETS as REF_TRAIN  # noqa: E402
from repro.core import dse as ref_dse  # noqa: E402
from repro.core import energy as ref_energy  # noqa: E402
from repro.core import objectives as ref_objectives  # noqa: E402
from repro.core.study import Workload as RefWorkload  # noqa: E402
from repro_torch.core import (INFER_PRESETS, TRAIN_PRESETS, Study,  # noqa: E402
                              Workload, dse, energy, gridtorch, objectives)

CPU = torch.device("cpu")
MULT = 1.15
GRID_MAX = 740_000_000_000          # gemma3-27b training's grid max
SIZES = (32, 64, 128, 256)          # a small lattice: grids of ~30 x 30
BUDGET = 256
PHASES = ("inference", "training")


def _same_bits(got, want) -> None:
    """``got`` (numpy, or a CPU tensor) equal to numpy's ``want``: float64,
    the same shape, NaN where it is NaN, and the same bits elsewhere (so
    also the sign of a zero)."""
    if isinstance(got, torch.Tensor):
        assert got.dtype == torch.float64
        got = got.numpy()
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    keep = ~np.isnan(want)
    np.testing.assert_array_equal(got.view(np.int64)[keep],
                                  want.view(np.int64)[keep])


# ---- compute_energy_batch over tensors --------------------------------------

def _energy_inputs(seed, n_rows, n_cols, hi, hw):
    """The arguments ``_EnergyFields.grids`` gives ``compute_energy_batch``:
    per-size-tuple columns of busy cycles, SRAM bits and sizes and DRAM
    bits, and an int64 cycles grid with zeros in it."""
    rng = np.random.default_rng(seed)

    def col(lo, top):
        return rng.integers(lo, top, size=(n_rows, 1), dtype=np.int64)

    l_total = rng.integers(1, hi, size=(n_rows, n_cols), dtype=np.int64)
    l_total.flat[rng.integers(0, l_total.size, size=1 + l_total.size // 7)] = 0
    kb = [rng.choice(np.array(SIZES + (512, 1024, 2048)), size=(n_rows, 1))
          * 1024 for _ in range(4)]
    return dict(c_sa=col(0, hi), c_simd=col(0, hi), l_total=l_total,
                sram_bits={b: col(0, 2 ** 42)
                           for b in energy.SRAM_BUFFER_ORDER},
                sram_sizes={"wbuf": kb[0], "ibuf": kb[1], "obuf": kb[2],
                            "bbuf": hw.bbuf, "vmem": kb[3]},
                dram_bits=col(0, 2 ** 44))


def _hold_batch(kw, hw) -> None:
    want = energy.compute_energy_batch(hw, **kw)
    ref = ref_energy.compute_energy_batch(hw, **kw)
    got = energy.compute_energy_batch(
        hw, **dict(kw, l_total=torch.from_numpy(kw["l_total"])))
    assert got.keys() == want.keys() == ref.keys()
    for k in want:
        assert isinstance(want[k], np.ndarray), k
        assert isinstance(got[k], torch.Tensor) and got[k].device == CPU, k
        assert got[k].shape == want[k].shape == kw["l_total"].shape, k
        _same_bits(want[k], ref[k])          # the port's numpy path as is
        _same_bits(got[k], want[k])
    zero = kw["l_total"] == 0
    assert zero.any()
    assert (got["P_avg"].numpy()[zero] == 0.0).all()


@pytest.mark.parametrize("hi", [2 ** 31, GRID_MAX])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("hw", [INFER_PRESETS[16], TRAIN_PRESETS[64]],
                         ids=["infer16", "train64"])
def test_energy_batch_on_tensors_matches_numpy(seed, hi, hw):
    _hold_batch(_energy_inputs(seed, 17, 23, hi, hw), hw)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), n_rows=st.integers(1, 12),
       n_cols=st.integers(1, 12),
       hi=st.sampled_from([2 ** 20, 2 ** 31, 2 ** 33, GRID_MAX]),
       preset=st.sampled_from([16, 32, 64]),
       training=st.booleans())
def test_energy_batch_on_drawn_grids(seed, n_rows, n_cols, hi, preset,
                                     training):
    hw = (TRAIN_PRESETS if training else INFER_PRESETS)[preset]
    _hold_batch(_energy_inputs(seed, n_rows, n_cols, hi, hw), hw)


def test_int64_tensor_is_made_float64_before_it_is_scaled():
    """Torch scales an int64 tensor by a Python float in float32 (numpy in
    float64); the report is float64 throughout, and exact where float32
    is not: cycles of 2**25 + 1 and 7.4e11 + 1."""
    assert (torch.tensor([3]) * 0.5).dtype == torch.float32
    hw = TRAIN_PRESETS[64]
    kw = _energy_inputs(5, 3, 4, 2 ** 20, hw)
    kw["l_total"][0, :2] = (2 ** 25 + 1, GRID_MAX + 1)
    _hold_batch(kw, hw)
    got = energy.compute_energy_batch(
        hw, **dict(kw, l_total=torch.from_numpy(kw["l_total"])))
    assert got["runtime_s"][0, 0].item() \
        == (2 ** 25 + 1) * energy.DEFAULT_ENERGY.t_clk_s


def test_array_namespace():
    assert energy.array_namespace(np.zeros(2)) is np
    assert energy.array_namespace(3) is np
    xp = energy.array_namespace(torch.zeros(2, dtype=torch.int64))
    assert xp is not np and xp.device == CPU
    half = xp.asarray(0.5)                   # numpy's dtype: float64
    assert half.dtype == torch.float64 and half.item() == 0.5
    cyc = xp.asarray(torch.tensor([2 ** 40 + 1]), dtype=float)
    assert cyc.dtype == torch.float64 and cyc.item() == 2 ** 40 + 1
    col = xp.asarray(np.arange(3, dtype=np.int64)[:, None] * 0.25)
    assert col.dtype == torch.float64 and tuple(col.shape) == (3, 1)
    z = xp.zeros_like(cyc)
    assert z.dtype == torch.float64 and z.item() == 0.0
    w = xp.where(cyc > 0, cyc, np.inf)
    assert w.dtype == torch.float64


def test_host_readable_reads_into_numpy_and_stays_a_tensor():
    t = torch.arange(6, dtype=torch.int64).reshape(2, 3)
    r = gridtorch._readable(t)
    assert isinstance(r, gridtorch.HostReadable)
    a = np.asarray(r, dtype=float)
    assert type(a) is np.ndarray and a.dtype == np.float64
    np.testing.assert_array_equal(a, t.numpy())
    assert isinstance(r * 2, gridtorch.HostReadable)
    assert type(gridtorch._plain_host(r)) is np.ndarray
    assert gridtorch._readable(a) is a


# ---- reduce_scored over a study's real energy fields ----------------------

def _fields(dse_mod, hw, layers, em):
    """The tables ``_grid_search_many`` reduces for one network, and its
    ``_EnergyFields``: the same lines, through ``dse_mod``."""
    size_tuples = dse_mod._tuples(SIZES, 4, BUDGET * 0.85, BUDGET * 1.15)
    bw_tuples = dse_mod._tuples(SIZES, 4, BUDGET * 0.85, BUDGET * 1.15)
    s3s, s3_of = dse_mod._project(size_tuples, lambda t: t[:3])
    vs, v_of = dse_mod._project(size_tuples, lambda t: t[3])
    b3s, b3_of = dse_mod._project(bw_tuples, lambda t: t[:3])
    ws, w_of = dse_mod._project(bw_tuples, lambda t: t[3])
    eng = dse_mod._GridEngine(hw, {"net": layers})
    conv, _, conv_e = eng.conv_matrices(s3s, b3s)
    simd, _, simd_e = eng.simd_matrices(vs, ws)
    fields = dse_mod._EnergyFields(
        hw=hw, em=em, conv=conv_e["net"], simd=simd_e["net"], s3_of=s3_of,
        v_of=v_of, sizes_kb=np.array(size_tuples, dtype=np.int64))
    return conv["net"], simd["net"], (s3_of, b3_of, v_of, w_of), fields


@pytest.fixture(scope="module")
def tables():
    """Per phase: ResNet-50 at the 16x16 preset, through each package."""
    out = {}
    for phase in PHASES:
        training = phase == "training"
        hw = (TRAIN_PRESETS if training else INFER_PRESETS)[16]
        ref_hw = (REF_TRAIN if training else REF_INFER)[16]
        out[phase] = (
            _fields(dse, hw, Workload("resnet50", training=training)
                    .layers(), energy.DEFAULT_ENERGY),
            _fields(ref_dse, ref_hw, RefWorkload(
                "resnet50", training=training).layers(),
                ref_energy.DEFAULT_ENERGY))
    return out


class _NanEnds:
    """Numpy only, as the JAX package's ``_NanBait``: cycles as float,
    NaN at the grid's least and greatest cycle counts."""
    name = "nan_ends"
    needs_energy = False

    def score(self, m):
        s = np.asarray(m.cycles, dtype=float).copy()
        flat = s.ravel()
        flat[flat.argmin()] = np.nan
        flat[flat.argmax()] = np.nan
        return flat.reshape(s.shape)


class _EnergyNanEnds:
    """Numpy only, and it pulls the report: E_total, NaN at the fastest
    and the slowest candidate."""
    name = "energy_nan_ends"
    needs_energy = True

    def score(self, m):
        e = np.array(m.energy, dtype=float)
        c = np.asarray(m.cycles)
        e.flat[c.argmin()] = np.nan
        e.flat[c.argmax()] = np.nan
        return e


def _numpy_engine(conv, simd, proj, fields, objective):
    """``_grid_search_many``'s numpy branch on the same tables."""
    s3_of, b3_of, v_of, w_of = proj
    costs = conv[np.ix_(s3_of, b3_of)] + simd[np.ix_(v_of, w_of)]
    mb = objectives.MetricBatch(costs, lambda: fields.grids(costs))
    scores = np.asarray(objective.score(mb), dtype=float)
    flat = scores.ravel()
    finite = np.isfinite(flat)
    bi = int(np.where(finite, flat, np.inf).argmin())
    wi = int(np.where(finite, flat, -np.inf).argmax())
    fm = flat <= flat[bi] * MULT
    return costs, scores, mb._report, bi, wi, bool(finite.any()), fm


def _cap(fields, conv, simd, proj):
    """A power cap between the grid's least and greatest ``P_avg``."""
    s3_of, b3_of, v_of, w_of = proj
    p = fields.grids(conv[np.ix_(s3_of, b3_of)]
                     + simd[np.ix_(v_of, w_of)])["P_avg"]
    assert p.min() < p.max()
    return float(np.median(p))


OBJECTIVES = ("energy", "edp", "power_cap", "nan_ends", "energy_nan_ends")


def _objective(name, mod, cap):
    if name == "power_cap":
        return mod.CyclesUnderPowerCap(cap_w=cap)
    if name == "nan_ends":
        return _NanEnds()
    if name == "energy_nan_ends":
        return _EnergyNanEnds()
    return mod.resolve_objective(name)


def _hold_reduction(got, want, label) -> None:
    costs, scores, report, bi, wi, feasible, fm = got
    assert costs.dtype == want[0].dtype == np.int64, label
    np.testing.assert_array_equal(costs, want[0])
    _same_bits(scores, want[1])
    if want[2] is None:
        assert report is None, label
    else:
        assert report.keys() == want[2].keys(), label
        for k in report:
            assert type(report[k]) is np.ndarray, (label, k)
            _same_bits(report[k], np.asarray(want[2][k]))
    assert (bi, wi, feasible) == tuple(want[3:6]), label
    np.testing.assert_array_equal(np.asarray(fm).ravel(),
                                  np.asarray(want[6]).ravel())


@pytest.mark.parametrize("name", OBJECTIVES)
@pytest.mark.parametrize("phase", PHASES)
def test_reduce_scored_matches_numpy_engine_and_gridax(jax_grid, tables,
                                                       phase, name):
    gridax, _ = jax_grid
    (conv, simd, proj, fields), (rconv, rsimd, rproj, rfields) = \
        tables[phase]
    np.testing.assert_array_equal(conv, rconv)
    cap = _cap(fields, conv, simd, proj)
    obj = _objective(name, objectives, cap)
    want = _numpy_engine(conv, simd, proj, fields, obj)
    got = gridtorch.reduce_scored(conv, simd, *proj, objective=obj,
                                  energy_grids_fn=fields.grids,
                                  frontier_mult=MULT, device=CPU)
    _hold_reduction(got, want, f"{phase}/{name}/torch")
    ref = gridax.reduce_scored(rconv, rsimd, *rproj,
                               objective=_objective(name, ref_objectives, cap),
                               energy_grids_fn=rfields.grids,
                               frontier_mult=MULT)
    _hold_reduction(ref, want, f"{phase}/{name}/gridax")
    if phase == "training":
        assert want[0].max() > 2 ** 31
    scores = want[1]
    if name == "power_cap":
        assert np.isinf(scores).any() and np.isfinite(scores).any()
    if name.endswith("nan_ends"):
        assert np.isnan(scores).sum() >= 1


def test_reduce_scored_hands_objectives_host_readable_tensors(tables):
    conv, simd, proj, fields = tables["inference"][0]
    seen = {}

    class _Spy:
        name = "spy"
        needs_energy = True

        def score(self, m):
            seen["cycles"], seen["edp"] = type(m.cycles), type(m.edp)
            seen["report"] = {type(v) for v in m.energy_report().values()}
            return m.edp

    out = gridtorch.reduce_scored(conv, simd, *proj, objective=_Spy(),
                                  energy_grids_fn=fields.grids,
                                  frontier_mult=MULT, device=CPU)
    assert seen == {"cycles": gridtorch.HostReadable,
                    "edp": gridtorch.HostReadable,
                    "report": {gridtorch.HostReadable}}
    assert type(out[1]) is np.ndarray
    assert {type(v) for v in out[2].values()} == {np.ndarray}


# ---- the torch backends score on the device --------------------------------

def _pt(p):
    return (p.sizes_kb, p.bws, p.cycles)


def _search(backend, objective, training=False):
    hw = (TRAIN_PRESETS if training else INFER_PRESETS)[16]
    return Study(hw, sizes=SIZES, bws=SIZES, backend=backend,
                 device="cpu").search(Workload("resnet50", training=training),
                                      BUDGET, BUDGET, objective=objective)


@pytest.fixture
def grids_spy(monkeypatch):
    """Every ``l_total`` that ``_EnergyFields.grids`` is handed."""
    seen = []
    grids = dse._EnergyFields.grids

    def spy(self, l_total):
        seen.append(l_total)
        return grids(self, l_total)
    monkeypatch.setattr(dse._EnergyFields, "grids", spy)
    return seen


@pytest.mark.parametrize("objective", ["energy", "edp", "energy_nan_ends"])
@pytest.mark.parametrize("backend", ["torch", "torch-fused"])
def test_torch_backends_build_the_report_from_a_tensor(grids_spy, backend,
                                                       objective):
    obj = _EnergyNanEnds() if objective == "energy_nan_ends" else objective
    got = _search(backend, obj)
    assert len(grids_spy) == 1
    assert isinstance(grids_spy[0], torch.Tensor)
    assert grids_spy[0].dtype == torch.int64
    assert {type(v) for v in got._energy_grids.values()} == {np.ndarray}
    grids_spy.clear()
    want = _search("numpy", obj)
    assert len(grids_spy) == 1 and type(grids_spy[0]) is np.ndarray
    assert (_pt(got.best), _pt(got.worst)) == (_pt(want.best),
                                               _pt(want.worst))
    assert [_pt(p) for p in got.points] == [_pt(p) for p in want.points]
    assert [_pt(p) for p in got.pareto()] == [_pt(p) for p in want.pareto()]
    np.testing.assert_array_equal(got.grid.costs, want.grid.costs)
    _same_bits(got.grid_scores, want.grid_scores)
    for k, v in want._energy_grids.items():
        _same_bits(got._energy_grids[k], v)


@pytest.mark.parametrize("backend", ["numpy", "torch", "torch-fused"])
def test_power_cap_searches(backend):
    """A cap between the least and greatest ``P_avg``: the torch backends'
    search equal to the numpy engine's; a cap below every candidate's
    ``P_avg`` raises, on every backend."""
    p = _search("numpy", "energy", training=True)._grid_energy()["P_avg"]
    cap = objectives.CyclesUnderPowerCap(cap_w=float(np.median(p)))
    got = _search(backend, cap, training=True)
    want = _search("numpy", cap, training=True)
    assert np.isinf(want.grid_scores).any()
    assert got.best.cycles == want.best.cycles
    assert _pt(got.worst) == _pt(want.worst)
    _same_bits(got.grid_scores, want.grid_scores)
    assert got.power_of() <= cap.cap_w
    with pytest.raises(ValueError, match="infeasible"):
        _search(backend, objectives.CyclesUnderPowerCap(
            cap_w=float(p.min()) / 2), training=True)


# ---- chip_smoke.py's holds of the scored searches, rehearsed --------------

@pytest.fixture
def smoke(monkeypatch):
    """``chip_smoke.py`` as a module, on the CPU at the small lattice."""
    from test_torch_serve import _smoke
    module = _smoke()
    monkeypatch.setattr(module, "CARD", "cpu")
    monkeypatch.setattr(module, "BUDGET_KB", BUDGET)
    monkeypatch.setattr(module, "BUDGET_BW", BUDGET)
    return module


@pytest.mark.parametrize("objective", ["energy", "edp", "power_cap",
                                       "energy_nan_ends"])
@pytest.mark.parametrize("backend", ["torch", "torch-fused"])
def test_smoke_holds_scored_searches_on_the_cpu(smoke, backend, objective):
    """The Recorder sees the report built once from a tensor on the
    study's device and no ``grid_minmax`` launch, and ``compare`` holds
    the search to the numpy engine's bit for bit (NaN scores included);
    a report that differs by one bit fails it."""
    study = dict(hw=TRAIN_PRESETS[16], sizes=SIZES, bws=SIZES)
    wl = dict(net="resnet50", training=True)
    if objective == "power_cap":
        p = smoke.run_search(dict(study, backend="numpy"), wl, "energy",
                             "cpu")._grid_energy()["P_avg"]
        obj = objectives.CyclesUnderPowerCap(cap_w=float(np.median(p)))
    elif objective == "energy_nan_ends":
        obj = smoke.EnergyNanEnds()
    else:
        obj = objective
    with smoke.Recorder() as rec:
        rec.zero(objective)
        got = smoke.run_search(dict(study, backend=backend), wl, obj, "cpu")
        launches, _, ref_calls = rec.read()
        smoke.check_scored(objective, obj, launches, rec.reports())
    assert rec.reports() == ["cpu"] and ref_calls == 0
    want = smoke.run_search(dict(study, backend="numpy"), wl, obj, "cpu")
    assert smoke.compare(objective, got, want) == 11
    if objective == "energy_nan_ends":
        assert np.isnan(got.grid_scores).sum() == 2
    got._energy_grids["E_S"].flat[7] = np.nextafter(
        got._energy_grids["E_S"].flat[7], np.inf)
    with pytest.raises(AssertionError, match="energy report differs"):
        smoke.compare(objective, got, want)

"""Hypothesis property tests for the port's ``method="refine"``: the twin
of ``tests/test_optimize_props.py``, on the CPU.

Over randomized networks, budgets, grids, tolerances and seeds drawn from
the same ranges (derandomized, so the examples are fixed): every point
the port's optimizer returns or costs satisfies the SRAM/bandwidth
budget, its optimum is never worse than the exhaustive power-of-two
grid's, and its result — best, worst, archive and trajectory — equals
the JAX package's refine on the same case.
"""
import pytest

pytest.importorskip(
    "hypothesis",
    reason="property tests need hypothesis (installed in CI; optional locally)")
pytest.importorskip("torch")
import hypothesis.strategies as st  # noqa: E402
from hypothesis import given, settings  # noqa: E402

from repro.core import HardwareSpec as RefHardwareSpec  # noqa: E402
from repro.core import layers as RL  # noqa: E402
from repro.core.optimize import RefineConfig as RefRefineConfig  # noqa: E402
from repro.core.study import Study as RefStudy  # noqa: E402
from repro.core.study import Workload as RefWorkload  # noqa: E402
from repro_torch.core import HardwareSpec  # noqa: E402
from repro_torch.core import layers as L  # noqa: E402
from repro_torch.core.optimize import RefineConfig  # noqa: E402
from repro_torch.core.study import Study, Workload  # noqa: E402


def _conv(mod, i, n, ic, oc, hw_sz, k, bias):
    return mod.ConvLayer(name=f"c{i}", n=n, ic=ic, ih=hw_sz + k - 1,
                         iw=hw_sz + k - 1, oc=oc, oh=hw_sz, ow=hw_sz,
                         kh=k, kw=k, s=1, has_bias=bias)


def _simd(mod, kind, i, h, c):
    if kind == "pool":
        return mod.pool(f"s{i}", h, h, 1, c, 2, 2)
    return {"relu": mod.relu, "add": mod.tensor_add,
            "bn": mod.batch_norm}[kind](f"s{i}", h, h, 1, c)


# layers are drawn as plain parameters and built in both packages
conv_strategy = st.fixed_dictionaries(dict(
    i=st.integers(0, 3), n=st.sampled_from([1, 4]),
    ic=st.sampled_from([8, 16, 32]), oc=st.sampled_from([16, 32, 64]),
    hw_sz=st.sampled_from([8, 14, 16, 28]), k=st.sampled_from([1, 3, 5]),
    bias=st.booleans()))

simd_strategy = st.fixed_dictionaries(dict(
    kind=st.sampled_from(["relu", "add", "bn", "pool"]),
    i=st.integers(0, 3), h=st.sampled_from([8, 14, 16]),
    c=st.sampled_from([16, 32, 64])))

case_strategy = st.fixed_dictionaries({
    "convs": st.lists(conv_strategy, min_size=1, max_size=2),
    "simds": st.lists(simd_strategy, min_size=1, max_size=2),
    "jk": st.sampled_from([8, 16, 32]),
    "grid": st.sampled_from([(32, 64, 128, 256), (64, 128, 256, 512)]),
    "budget_mult": st.integers(2, 5),     # budget = mult * min(grid) * 2
    "tol": st.sampled_from([0.15, 0.3, 0.5]),
    "training": st.booleans(),
    "seed": st.integers(0, 2**31 - 1),
})


def _net(mod, case):
    return tuple([_conv(mod, **c) for c in case["convs"]]
                 + [_simd(mod, **s) for s in case["simds"]])


def _pt(p):
    return (p.sizes_kb, p.bws, p.cycles)


def _run(case):
    grid_vals = case["grid"]
    budget = case["budget_mult"] * min(grid_vals) * 2
    kw = dict(sizes=grid_vals, bws=grid_vals, tol=case["tol"])
    wl = Workload(_net(L, case), training=case["training"])
    study = Study(HardwareSpec(J=case["jk"], K=case["jk"]), backend="torch",
                  device="cpu", **kw)
    g = study.search(wl, budget, budget)
    # the grid's own candidate count as the evaluation grant, as in the
    # reference's property tests (the default cap is tuned for +-15%)
    r = study.search(wl, budget, budget, method="refine",
                     refine=RefineConfig(seed=case["seed"],
                                         max_evals=g.n_candidates))
    ref_study = RefStudy(RefHardwareSpec(J=case["jk"], K=case["jk"]), **kw)
    ref = ref_study.search(
        RefWorkload(_net(RL, case), training=case["training"]), budget,
        budget, method="refine",
        refine=RefRefineConfig(seed=case["seed"], max_evals=g.n_candidates))
    return grid_vals, budget, case["tol"], g, r, ref


@settings(max_examples=20, deadline=None, derandomize=True)
@given(case=case_strategy)
def test_refine_respects_budget_constraints(case):
    grid_vals, budget, tol, _, r, _ = _run(case)
    lo, hi = budget * (1 - tol), budget * (1 + tol)
    vmin, vmax = min(grid_vals), max(grid_vals)
    for p in [r.best, r.worst] + r.archive:
        assert lo <= p.total_size_kb <= hi
        assert lo <= p.total_bw <= hi
        assert all(vmin <= v <= vmax for v in p.sizes_kb + p.bws)


@settings(max_examples=20, deadline=None, derandomize=True)
@given(case=case_strategy)
def test_refine_never_worse_than_grid_and_equals_reference(case):
    _, _, _, g, r, ref = _run(case)
    assert r.best.cycles <= g.best.cycles
    assert _pt(r.best) == _pt(ref.best) and _pt(r.worst) == _pt(ref.worst)
    assert [_pt(p) for p in r.archive] == [_pt(p) for p in ref.archive]
    assert [(s, k, _pt(p)) for s, k, p in r.refine.trajectory] == \
        [(s, k, _pt(p)) for s, k, p in ref.refine.trajectory]

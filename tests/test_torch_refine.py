"""The port's ``method="refine"`` (``repro_torch.core.optimize``) against
the JAX package's (``repro.core.optimize``), on the CPU.

On ``tests/test_refine.py``'s fixtures — the Table VIII budgets at every
array size, ResNet-50 inference and training, and its tiny networks — the
port's refine gives the reference's results exactly: the same best and
worst points, the same archive in the same order, the same trace (seed,
starts, evaluation counts, trajectory) and, for energy and EDP, the same
scores.  The port's own contracts are held too: never worse than the
grid's best at ten times fewer evaluations, seed-deterministic
trajectories, exact phase attribution off the lattice, and the
zero-conv (GEMM + SIMD) workloads of ``tests/test_gemm.py``.  Refine
prices on the host's numpy tables, so a study's ``backend`` and
``device`` do not change it.
"""
import inspect

import pytest

pytest.importorskip("torch")

from repro.core import INFER_PRESETS as REF_INFER  # noqa: E402
from repro.core import TRAIN_PRESETS as REF_TRAIN  # noqa: E402
from repro.core import layers as RL  # noqa: E402
from repro.core.networks import resnet50 as ref_resnet50  # noqa: E402
from repro.core.optimize import RefineConfig as RefRefineConfig  # noqa: E402
from repro.core.study import Study as RefStudy  # noqa: E402
from repro.core.study import Workload as RefWorkload  # noqa: E402
from repro_torch.core import INFER_PRESETS, TRAIN_PRESETS  # noqa: E402
from repro_torch.core import layers as L  # noqa: E402
from repro_torch.core import optimize  # noqa: E402
from repro_torch.core.dse import (DSE_BACKENDS, SIZES_KB, BWS,  # noqa: E402
                                  clear_table_caches, table_cache_stats)
from repro_torch.core.networks import resnet50  # noqa: E402
from repro_torch.core.optimize import RefineConfig  # noqa: E402
from repro_torch.core.study import Study, Workload  # noqa: E402

BUDGETS = {16: 512, 32: 1024, 64: 2048, 128: 4096}   # Table VIII
GRID = (32, 64, 128, 256)
BWG = (8, 16, 32, 64)


def _hw(presets, jk):
    return presets.get(jk, presets[64]).replace(J=jk, K=jk)


def _conv(mod, name, **kw):
    base = dict(name=name, n=1, ic=16, ih=16, iw=16, oc=32, oh=16, ow=16,
                kh=3, kw=3, s=1, has_bias=True)
    base.update(kw)
    return mod.ConvLayer(**base)


def tiny_net(mod):
    """``tests/test_refine.py::tiny_net`` built from ``mod``'s layers."""
    return (_conv(mod, "c1"), mod.relu("r1", 16, 16, 1, 32),
            _conv(mod, "c2", ic=32, oc=32, has_bias=False),
            mod.pool("p1", 8, 8, 1, 32, 2, 2),
            mod.tensor_add("a1", 8, 8, 1, 32), mod.fc("fc", 1, 2048, 100))


def tiny_train_net(mod):
    return (_conv(mod, "c1", has_bias=False),
            mod.batch_norm("c1.bn", 16, 16, 1, 32),
            mod.relu("c1.relu", 16, 16, 1, 32), _conv(mod, "c2", ic=32, oc=32),
            mod.pool("p1", 8, 8, 1, 32, 2, 2),
            mod.tensor_add("a1", 8, 8, 1, 32), mod.fc("fc", 1, 2048, 10))


def attn_net(mod):
    """``tests/test_gemm.py::attn_net``: one zero-conv attention block."""
    return (mod.rmsnorm("norm", 64, 1024), mod.gemm("q", 64, 1024, 1024),
            mod.gemm("scores", 64, 64, 64, count=16, param=False),
            mod.softmax("sm", 16 * 64, 64),
            mod.gemm("av", 64, 64, 64, count=16, param=False),
            mod.gemm("o", 64, 1024, 1024))


def _pt(p):
    return (p.sizes_kb, p.bws, p.cycles)


def _trace(t):
    return (t.seed, t.n_starts, t.n_evals, t.n_size_triples, t.n_vmems,
            t.grid_candidates,
            tuple((s, stride, _pt(p)) for s, stride, p in t.trajectory))


def assert_same_refine(got, want):
    """The port's refine result equals the reference's, point for point."""
    assert _pt(got.best) == _pt(want.best)
    assert _pt(got.worst) == _pt(want.worst)
    assert got.objective == want.objective
    assert [_pt(p) for p in got.archive] == [_pt(p) for p in want.archive]
    assert _trace(got.refine) == _trace(want.refine)
    assert got.n_candidates == want.n_candidates == got.refine.n_evals
    assert [_pt(p) for p in got.points] == [_pt(p) for p in want.points]
    assert [_pt(p) for p in got.pareto()] == [_pt(p) for p in want.pareto()]
    assert got.best_score == want.best_score
    assert got.energy_report() == want.energy_report()
    assert got.phase_breakdown().cycles == want.phase_breakdown().cycles


@pytest.fixture(scope="module")
def table8():
    """Grid and refine for every Table VIII budget, ResNet-50 inference
    (batch 1, BN folded) and training (batch 32), in both packages."""
    out = {}
    for mode, presets, ref_presets, training in (
            ("inference", INFER_PRESETS, REF_INFER, False),
            ("training", TRAIN_PRESETS, REF_TRAIN, True)):
        batch = 32 if training else 1
        wl = Workload("resnet50", training=training, batch=batch)
        ref_wl = RefWorkload("resnet50", training=training, batch=batch)
        for jk, budget in BUDGETS.items():
            port = Study(_hw(presets, jk), backend="torch", device="cpu")
            ref = RefStudy(_hw(ref_presets, jk), backend="numpy")
            out[mode, jk] = (
                budget, port.search(wl, budget, budget),
                port.search(wl, budget, budget, method="refine"),
                ref.search(ref_wl, budget, budget, method="refine"))
    return out


@pytest.mark.parametrize("mode", ["inference", "training"])
@pytest.mark.parametrize("jk", [16, 32, 64, 128])
def test_refine_matches_reference(table8, mode, jk):
    _, _, r, ref = table8[(mode, jk)]
    assert_same_refine(r, ref)


@pytest.mark.parametrize("mode", ["inference", "training"])
@pytest.mark.parametrize("jk", [16, 32, 64, 128])
def test_refine_never_worse_and_10x_cheaper(table8, mode, jk):
    budget, g, r, _ = table8[(mode, jk)]
    assert r.best.cycles <= g.best.cycles
    assert r.n_candidates * 10 <= g.n_candidates
    assert r.refine.eval_saving >= 10.0
    lo, hi = budget * 0.85, budget * 1.15
    assert lo <= r.best.total_size_kb <= hi
    assert lo <= r.best.total_bw <= hi


def test_refine_beats_lattice_and_leaves_it(table8):
    _, g64, r64, _ = table8[("inference", 64)]
    assert r64.best.cycles < g64.best.cycles
    assert r64.archive and r64.n_candidates == len(r64.archive)
    assert any(p == r64.best for p in r64.archive)
    assert any(v not in SIZES_KB for v in r64.best.sizes_kb) \
        or any(v not in BWS for v in r64.best.bws)


@pytest.mark.parametrize("jk", [16, 32, 64, 128])
def test_lattice_refine_matches_grid_and_reference(table8, jk):
    """Restricted to the lattice, refine lands on the grid's best point,
    as the reference's does, along the same trajectory."""
    budget, g, _, _ = table8[("inference", jk)]
    cfg = dict(lattice_only=True)
    got = Study(_hw(INFER_PRESETS, jk), device="cpu").search(
        Workload("resnet50"), budget, budget, method="refine",
        refine=RefineConfig(**cfg))
    want = RefStudy(_hw(REF_INFER, jk)).search(
        RefWorkload("resnet50"), budget, budget, method="refine",
        refine=RefRefineConfig(**cfg))
    assert got.best == g.best
    assert got.n_candidates * 10 <= g.n_candidates
    assert_same_refine(got, want)


def test_lattice_refine_matches_grid_training():
    """The joint size + bandwidth move of ``tests/test_refine.py`` on the
    16x16 training fixture."""
    wl = Workload("resnet50", training=True, batch=32)
    study = Study(_hw(TRAIN_PRESETS, 16), backend="torch", device="cpu")
    g = study.search(wl, 512, 512)
    got = study.search(wl, 512, 512, method="refine",
                       refine=RefineConfig(lattice_only=True))
    want = RefStudy(_hw(REF_TRAIN, 16)).search(
        RefWorkload("resnet50", training=True, batch=32), 512, 512,
        method="refine", refine=RefRefineConfig(lattice_only=True))
    assert got.best == g.best
    assert_same_refine(got, want)


def test_lattice_refine_costs_bit_identical_to_grid():
    study = Study(INFER_PRESETS[16], sizes=GRID, bws=GRID, tol=0.5,
                  backend="torch", device="cpu")
    wl = Workload(tiny_net(L))
    g = study.search(wl, 256, 256)
    rl = study.search(wl, 256, 256, method="refine",
                      refine=RefineConfig(lattice_only=True))
    for p in rl.archive:
        si, bi = g.grid.locate(p)
        assert int(g.grid.costs[si, bi]) == p.cycles


# ---------------------------------------------------------------------------
# determinism, the same trajectories as the reference
# ---------------------------------------------------------------------------

def _tiny_pair(**kw):
    kw = dict(sizes=GRID, bws=GRID, tol=0.5, **kw)
    return (Study(INFER_PRESETS[16], device="cpu", **kw),
            RefStudy(REF_INFER[16], **kw))


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_identical_seed_identical_trajectory_and_reference(seed):
    port, ref = _tiny_pair()
    wl, ref_wl = Workload(tiny_net(L)), RefWorkload(tiny_net(RL))
    r1 = port.search(wl, 256, 256, method="refine",
                     refine=RefineConfig(seed=seed))
    r2 = port.search(wl, 256, 256, method="refine",
                     refine=RefineConfig(seed=seed))
    assert r1.refine.trajectory == r2.refine.trajectory
    assert r1.archive == r2.archive and r1 == r2
    want = ref.search(ref_wl, 256, 256, method="refine",
                      refine=RefRefineConfig(seed=seed))
    assert_same_refine(r1, want)


def test_search_many_matches_search_trajectory():
    port, ref = _tiny_pair()
    nets = {"a": Workload(tiny_net(L)), "b": Workload(tiny_train_net(L))}
    single = port.search(nets["a"], 256, 256, method="refine",
                         refine=RefineConfig(seed=5))
    many = port.search_many(nets, 256, 256, method="refine",
                            refine=RefineConfig(seed=5))
    assert many["a"].refine.trajectory == single.refine.trajectory
    assert many["a"].best == single.best
    assert many["a"].archive == single.archive
    ref_many = ref.search_many(
        {"a": RefWorkload(tiny_net(RL)), "b": RefWorkload(tiny_train_net(RL))},
        256, 256, method="refine", refine=RefRefineConfig(seed=5))
    for key in nets:
        assert_same_refine(many[key], ref_many[key])


@pytest.mark.parametrize("training", [False, True])
def test_phase_breakdown_partitions_off_lattice(training):
    port, ref = _tiny_pair()
    net = tiny_train_net if training else tiny_net
    r = port.search(Workload(net(L), training=training), 256, 256,
                    method="refine")
    for p in [r.best, r.worst] + r.archive[::41]:
        pb = r.phase_breakdown(p)
        assert pb.total == p.cycles
        assert pb.conv_cycles + pb.nonconv_cycles == p.cycles
        assert pb.fwd_cycles + pb.bwd_cycles == p.cycles
    assert any(any(v not in GRID for v in p.sizes_kb + p.bws)
               for p in r.archive)
    want = ref.search(RefWorkload(net(RL), training=training), 256, 256,
                      method="refine")
    assert_same_refine(r, want)
    for got_p, want_p in zip(r.archive[::41], want.archive[::41]):
        assert r.phase_breakdown(got_p).cycles == \
            want.phase_breakdown(want_p).cycles


@pytest.mark.parametrize("obj", ["energy", "edp"])
def test_refine_objectives_match_reference(obj):
    port, ref = _tiny_pair()
    got = port.search(Workload(tiny_net(L)), 256, 256, objective=obj,
                      method="refine")
    want = ref.search(RefWorkload(tiny_net(RL)), 256, 256, objective=obj,
                      method="refine")
    assert_same_refine(got, want)
    assert got.archive_scores == want.archive_scores


def test_single_engine_nets_match_reference():
    port, ref = _tiny_pair()
    for pick in (lambda n: (n[0], n[-1]), lambda n: (n[1], n[4])):
        got = port.search(Workload(pick(tiny_net(L))), 256, 256,
                          method="refine")
        g = port.search(Workload(pick(tiny_net(L))), 256, 256)
        want = ref.search(RefWorkload(pick(tiny_net(RL))), 256, 256,
                          method="refine")
        assert got.best.cycles <= g.best.cycles
        assert got.phase_breakdown().total == got.best.cycles
        assert_same_refine(got, want)


# ---------------------------------------------------------------------------
# zero-conv workloads (tests/test_gemm.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("training", [False, True])
def test_zero_conv_refine_matches_reference(training):
    presets, ref_presets = ((TRAIN_PRESETS, REF_TRAIN) if training
                            else (INFER_PRESETS, REF_INFER))
    study = Study(presets[16], sizes=GRID, bws=BWG, device="cpu")
    wl = Workload(attn_net(L), training=training)
    g = study.search(wl, 512, 64)
    r = study.search(wl, 512, 64, method="refine")
    assert r.best.cycles <= int(g.best.cycles * 1.10)
    pb = r.phase_breakdown()
    assert pb.total == r.best.cycles
    assert pb.as_dict().get("conv:fwd", 0) == 0
    assert r.energy_of(r.best) > 0
    want = RefStudy(ref_presets[16], sizes=GRID, bws=BWG).search(
        RefWorkload(attn_net(RL), training=training), 512, 64,
        method="refine")
    assert_same_refine(r, want)


@pytest.mark.parametrize("name", ["gemma3_27b", "qwen3_0_6b"])
def test_llm_training_refine_matches_reference(name):
    study = Study(TRAIN_PRESETS[16], sizes=GRID, bws=BWG, device="cpu")
    wl = Workload(name, training=True, seq=64)
    g = study.search(wl, 512, 64)
    r = study.search(wl, 512, 64, method="refine")
    assert r.best.cycles <= g.best.cycles
    assert r.phase_breakdown().total == r.best.cycles
    assert r.energy_of(r.best) > 0
    want = RefStudy(REF_TRAIN[16], sizes=GRID, bws=BWG).search(
        RefWorkload(name, training=True, seq=64), 512, 64, method="refine")
    assert_same_refine(r, want)


# ---------------------------------------------------------------------------
# the front-end's plumbing in the port
# ---------------------------------------------------------------------------

def test_refine_takes_no_backend_or_device():
    params = inspect.signature(optimize.refine_search_many).parameters
    assert "backend" not in params and "device" not in params
    assert not any(p.kind is inspect.Parameter.VAR_KEYWORD
                   for p in params.values())


def test_refine_is_the_same_on_every_backend():
    wl = Workload(tiny_net(L))
    results = [Study(INFER_PRESETS[16], sizes=GRID, bws=GRID, tol=0.5,
                     backend=b, device="cpu").search(wl, 256, 256,
                                                     method="refine")
               for b in DSE_BACKENDS]
    for r in results[1:]:
        assert r == results[0] and r.archive == results[0].archive
        assert r.refine == results[0].refine


def test_refine_registers_on_a_study_with_its_own_methods():
    study = Study(INFER_PRESETS[16], sizes=GRID, bws=GRID, tol=0.5,
                  device="cpu")
    study.register_method("other", lambda *a, **k: {})
    r = study.search(Workload(tiny_net(L)), 256, 256, method="refine")
    assert study._methods["refine"] is optimize.refine_search_many
    assert r.refine is not None


def test_refine_reuses_tables_across_front_ends():
    clear_table_caches()
    study = Study(INFER_PRESETS[16], sizes=GRID, bws=GRID, tol=0.5,
                  backend="torch", device="cpu")
    wl = Workload(tiny_net(L))
    study.search(wl, 256, 256)
    after_grid = table_cache_stats()
    study.search(wl, 256, 256, method="refine",
                 refine=RefineConfig(lattice_only=True))
    after_lattice = table_cache_stats()
    assert after_lattice["conv_misses"] == after_grid["conv_misses"]
    assert after_lattice["conv_hits"] > after_grid["conv_hits"]


def test_unknown_method_and_misplaced_refine_config_raise():
    study = Study(INFER_PRESETS[16], sizes=GRID, bws=GRID, tol=0.5,
                  device="cpu")
    wl = Workload(tiny_net(L))
    with pytest.raises(ValueError, match="unknown search method"):
        study.search(wl, 256, 256, method="anneal")
    with pytest.raises(ValueError, match="refine config"):
        study.search(wl, 256, 256, method="grid", refine=RefineConfig())

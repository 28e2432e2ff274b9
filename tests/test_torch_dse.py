"""The port's DSE study against the JAX package's numpy engine and its
scalar ``search_reference``, on the CPU.

Pinned on the paper's Table VIII setup (16x16 array, power-of-two
lattice, 2048 KB / 2048 budgets) for ResNet-50 inference and training,
objectives cycles/energy/EDP, with both torch backends at
``device="cpu"``.  Bit-identical, not close: the same best/worst points,
the same frontiers in the same order, the same Pareto sets, bitwise-equal
int64 cost grids and float64 score grids.  Also pinned: the port refuses
to fall back (no CUDA, unknown backend), runs the front-ends it once
refused (refine, LLM names), and its table store never shares a file
with the JAX package's.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import INFER_PRESETS as REF_INFER  # noqa: E402
from repro.core import TRAIN_PRESETS as REF_TRAIN  # noqa: E402
from repro.core.dse import search_reference  # noqa: E402
from repro.core.study import Study as RefStudy  # noqa: E402
from repro.core.study import Workload as RefWorkload  # noqa: E402
from repro_torch.core import (INFER_PRESETS, TRAIN_PRESETS, Study,  # noqa: E402
                              Workload)
from repro_torch.core.dse import DSE_BACKENDS, resolve_backend  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
BUDGET_KB = 2048
BUDGET_BW = 2048
OBJECTIVES = ("cycles", "energy", "edp")
PHASES = ("inference", "training")
PORT_BACKENDS = ("torch", "torch-fused")


def _setup(phase):
    training = phase == "training"
    presets = (TRAIN_PRESETS, REF_TRAIN) if training \
        else (INFER_PRESETS, REF_INFER)
    return (presets[0][16], Workload("resnet50", training=training),
            presets[1][16], RefWorkload("resnet50", training=training))


def _pt(p):
    return (p.sizes_kb, p.bws, p.cycles)


def _pts(points):
    return [_pt(p) for p in points]


def _summary(res):
    """Everything a result exposes, in comparable form, computed once."""
    return {
        "best": _pt(res.best), "worst": _pt(res.worst),
        "improvement": res.improvement, "objective": res.objective,
        "points": _pts(res.points), "within_5": _pts(res.within(0.05)),
        "pareto": _pts(res.pareto()),
        "min_sram": _pt(res.economic_min_sram()),
        "min_bw": _pt(res.economic_min_bw()),
        "energy_report": res.energy_report(),
        "phases": res.phase_breakdown().cycles,
        "size_tuples": res.grid.size_tuples, "bw_tuples": res.grid.bw_tuples,
    }


@pytest.fixture(scope="module")
def table8():
    """Every (phase, engine, objective) search once — the port's two torch
    backends on the CPU, the JAX package's numpy engine — plus the scalar
    reference walk per phase."""
    out = {}
    for phase in PHASES:
        hw, wl, ref_hw, ref_wl = _setup(phase)
        ref = RefStudy(ref_hw, backend="numpy")
        ports = {b: Study(hw, backend=b, device="cpu") for b in PORT_BACKENDS}
        for obj in OBJECTIVES:
            out[phase, "ref", obj] = ref.search(ref_wl, BUDGET_KB, BUDGET_BW,
                                                objective=obj)
            for b, study in ports.items():
                out[phase, b, obj] = study.search(wl, BUDGET_KB, BUDGET_BW,
                                                  objective=obj)
        out[phase, "scalar"] = search_reference(ref_hw, ref_wl.layers(),
                                                BUDGET_KB, BUDGET_BW)
    return out


@pytest.fixture(scope="module")
def summaries(table8):
    return {k: _summary(v) for k, v in table8.items() if k[1] != "scalar"}


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("obj", OBJECTIVES)
@pytest.mark.parametrize("phase", PHASES)
def test_port_matches_numpy_engine(table8, summaries, phase, obj, backend):
    sa, sb = summaries[phase, "ref", obj], summaries[phase, backend, obj]
    assert sa.keys() == sb.keys()
    for key in sa:
        assert sa[key] == sb[key], key
    assert sb["objective"] == obj
    a, b = table8[phase, "ref", obj], table8[phase, backend, obj]
    assert a.grid.costs.dtype == b.grid.costs.dtype == np.int64
    assert np.array_equal(a.grid.costs, b.grid.costs)
    if obj == "cycles":
        assert a.grid_scores is None and b.grid_scores is None
    else:
        assert b.grid_scores.dtype == np.float64
        assert np.array_equal(a.grid_scores, b.grid_scores)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("phase", PHASES)
def test_port_matches_scalar_reference(table8, summaries, phase, backend):
    ref = table8[phase, "scalar"]
    got = summaries[phase, backend, "cycles"]
    assert got["best"] == _pt(ref.best)
    assert got["worst"] == _pt(ref.worst)
    assert got["points"] == _pts(ref.within(0.15))


def test_training_grid_exceeds_int32(table8):
    res = table8["training", "torch-fused", "cycles"]
    assert res.grid.costs.dtype == np.int64
    assert int(res.grid.costs.max()) > 2 ** 31
    assert int(res.worst.cycles) > 2 ** 31


def test_search_many_batched_matches_numpy():
    hw = INFER_PRESETS[16]
    nets = {"resnet50": "resnet50", "vgg16": "vgg16", "alexnet": "alexnet"}
    ref = RefStudy(REF_INFER[16], backend="numpy").search_many(
        nets, BUDGET_KB, BUDGET_BW)
    for backend in PORT_BACKENDS:
        got = Study(hw, backend=backend, device="cpu").search_many(
            nets, BUDGET_KB, BUDGET_BW)
        for name in nets:
            assert _pt(got[name].best) == _pt(ref[name].best)
            assert _pt(got[name].worst) == _pt(ref[name].worst)
            assert _pts(got[name].points) == _pts(ref[name].points)
            assert np.array_equal(got[name].grid.costs, ref[name].grid.costs)


def test_study_refuses_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs there")
    for backend in ("numpy",) + PORT_BACKENDS:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Study(INFER_PRESETS[16], backend=backend)
    assert Study(INFER_PRESETS[16], device="cpu").device.type == "cpu"


def test_default_backend_is_fused_and_unknown_backends_raise(monkeypatch):
    monkeypatch.delenv("REPRO_DSE_BACKEND", raising=False)
    assert resolve_backend(None) == "torch-fused"
    assert DSE_BACKENDS == ("numpy", "torch", "torch-fused")
    for name in DSE_BACKENDS:
        assert resolve_backend(name) == name
    for bad in ("jax", "jax-fused", "cuda", ""):
        with pytest.raises(ValueError, match="unknown DSE backend"):
            resolve_backend(bad)
    monkeypatch.setenv("REPRO_DSE_BACKEND", "jax")
    with pytest.raises(ValueError, match="REPRO_DSE_BACKEND"):
        Study(INFER_PRESETS[16], device="cpu")
    monkeypatch.setenv("REPRO_DSE_BACKEND", "numpy")
    assert Study(INFER_PRESETS[16], device="cpu").backend == "numpy"


def test_unported_front_ends_raise():
    """Once refused, now ported: ``method="refine"`` runs and never does
    worse than the grid, an LLM name resolves to a GEMM + SIMD graph, and
    a misspelt name raises ``ValueError`` listing both registries, as the
    JAX package's ``Workload`` does."""
    study = Study(INFER_PRESETS[16], backend="numpy", device="cpu")
    wl = Workload("resnet50")
    grid = study.search(wl, BUDGET_KB, BUDGET_BW)
    refined = study.search(wl, BUDGET_KB, BUDGET_BW, method="refine")
    assert refined.refine is not None and refined.archive
    assert refined.best.cycles <= grid.best.cycles
    layers = Workload("qwen3_0_6b").layers()
    assert [dataclasses.astuple(l) for l in layers] == \
        [dataclasses.astuple(l) for l in RefWorkload("qwen3_0_6b").layers()]
    with pytest.raises(ValueError, match="unknown network") as err:
        Workload("qwen3_0_6").layers()
    assert "resnet50" in str(err.value) and "qwen3_0_6b" in str(err.value)


def test_store_never_shares_files_with_reference(tmp_path):
    """A store directory warmed by the JAX package is searched by the port
    in a fresh process: the port reads none of the reference's files
    (they would unpickle ``repro.core.dse``), and ``repro`` never enters
    ``sys.modules``."""
    from repro.core.dse import clear_table_caches
    store = tmp_path / "store"
    grid = (64, 128, 256, 512)
    ref = RefStudy(REF_INFER[16], sizes=grid, bws=grid, backend="numpy",
                   store=store).search(RefWorkload("resnet50"), 1024, 1024)
    clear_table_caches()
    ref_files = {p.name for p in store.glob("*.tbl")}
    assert ref_files
    script = textwrap.dedent(f"""
        import json, sys
        sys.modules["jax"] = None
        from repro_torch.core import INFER_PRESETS, Study, Workload
        from repro_torch.core.dse import table_cache_stats
        grid = {grid!r}
        res = Study(INFER_PRESETS[16], sizes=grid, bws=grid,
                    backend="torch-fused", device="cpu",
                    store={str(store)!r}).search(Workload("resnet50"),
                                                 1024, 1024)
        stats = table_cache_stats()
        print(json.dumps({{
            "repro": sorted(m for m in sys.modules
                            if m == "repro" or m.startswith("repro.")),
            "best": [res.best.sizes_kb, res.best.bws, res.best.cycles],
            "hits": stats["store_hits"], "corrupt": stats["store_corrupt"],
        }}))
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("REPRO_DSE_BACKEND", None)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["repro"] == []
    assert out["hits"] == 0 and out["corrupt"] == 0
    assert out["best"] == [list(ref.best.sizes_kb), list(ref.best.bws),
                           ref.best.cycles]
    port_files = {p.name for p in store.glob("*.tbl")} - ref_files
    assert port_files                      # the port wrote its own entries
    assert ref_files <= {p.name for p in store.glob("*.tbl")}

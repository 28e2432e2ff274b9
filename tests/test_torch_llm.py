"""The port's LLM front-end against the JAX package's, on the CPU.

The configurations (``repro_torch.configs``), the lowering to a GEMM +
SIMD layer graph (``repro_torch.models.frontends.lower_llm``) and the
``Workload`` name resolution are held field by field against
``repro.configs``/``repro.models.frontends``/``repro.core.study``: the two
packages' layer and config classes differ, so layers compare through
``dataclasses.astuple`` and ``dtype`` maps from jnp to torch.  The
searches of ``tests/test_gemm.py``'s qwen3 and gemma3 fixtures (16x16
array, ``GRID``/``BWG`` lattice, 512 KB / 64) are bit-identical to the
JAX package's numpy engine and to its scalar ``search_reference``
through every backend of the port (numpy, torch and torch-fused on the
CPU).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.core import INFER_PRESETS as REF_INFER  # noqa: E402
from repro.core import TRAIN_PRESETS as REF_TRAIN  # noqa: E402
from repro.core.dse import search_reference  # noqa: E402
from repro.core.study import Study as RefStudy  # noqa: E402
from repro.core.study import Workload as RefWorkload  # noqa: E402
from repro.models import frontends as ref_frontends  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import (INFER_PRESETS, TRAIN_PRESETS, Study,  # noqa: E402
                              Workload)
from repro_torch.core.backward import expand_training_graph  # noqa: E402
from repro_torch.core.dse import DSE_BACKENDS  # noqa: E402
from repro_torch.kernels import forward as F  # noqa: E402
from repro_torch.models import frontends  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402

DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32,
          jnp.int8: torch.int8, None: None}
GRID = (32, 64, 128, 256)
BWG = (8, 16, 32, 64)
OBJECTIVES = ("cycles", "energy", "edp")
# (name, training, seq) of tests/test_gemm.py's qwen3 and gemma3 fixtures
FIXTURES = {"qwen3": ("qwen3_0_6b", False, 64),
            "qwen3:train": ("qwen3_0_6b", True, 64),
            "gemma3:train": ("gemma3_27b", True, 64)}


def _config_tuple(cfg, dtype_map=None):
    out = dataclasses.asdict(cfg)
    if dtype_map is not None:
        out["dtype"] = dtype_map[out["dtype"]]
        out["cache_dtype"] = dtype_map[out["cache_dtype"]]
    return out


def _layers(layers):
    return [(type(l).__name__, dataclasses.astuple(l)) for l in layers]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_registry_matches_reference():
    assert configs.ARCHS == ref_configs.ARCHS
    assert configs._MODULES == ref_configs._MODULES
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("qwen3-0.6")


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_config_matches_reference(arch, reduced):
    got, want = configs.get_config(arch), ref_configs.get_config(arch)
    if reduced:
        got, want = configs.reduced(got), ref_configs.reduced(want)
    assert isinstance(got, ModelConfig)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert _config_tuple(got) == _config_tuple(want, DTYPES)
    assert got.dtype is torch.bfloat16 and got.cache_dtype is None
    assert (got.hd, got.pattern, got.layer_kinds()) == \
        (want.hd, want.pattern, want.layer_kinds())
    assert [got.is_moe_layer(i) for i in range(got.n_layers)] == \
        [want.is_moe_layer(i) for i in range(want.n_layers)]


def test_replace_keeps_the_port_class():
    cfg = configs.get_config("qwen3-0.6b").replace(n_layers=2)
    assert isinstance(cfg, ModelConfig) and cfg.n_layers == 2


def test_forward_dims_are_qwen3_config():
    cfg = configs.get_config("qwen3-0.6b")
    assert F.QWEN3_0_6B == F.DecoderDims(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.hd, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
        n_layers=cfg.n_layers)
    assert F.QWEN3_0_6B == F.DecoderDims(
        d_model=1024, n_heads=16, n_kv=8, head_dim=128, d_ff=3072,
        vocab=151936, n_layers=28)


# ---------------------------------------------------------------------------
# lowering and name resolution
# ---------------------------------------------------------------------------

def test_config_names_match_reference():
    assert frontends.llm_config_names() == ref_frontends.llm_config_names()
    assert frontends.LLM_SEQ_DEFAULT == ref_frontends.LLM_SEQ_DEFAULT
    assert frontends.resolve_llm_config("resnet50") is None


@pytest.mark.parametrize("training", [False, True],
                         ids=["inference", "training"])
@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_workload_layers_match_reference(arch, training):
    """``Workload(name).layers()`` at the default batch and sequence,
    inference and after ``expand_training_graph``."""
    got = Workload(arch, training=training).layers()
    want = RefWorkload(arch, training=training).layers()
    assert len(got) == len(want) > 0
    assert _layers(got) == _layers(want)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-27b",
                                  "whisper-tiny", "pixtral-12b"])
def test_lower_llm_matches_reference_at_batch_and_seq(arch):
    got = frontends.lower_llm(configs.get_config(arch), batch=2, seq=2048)
    want = ref_frontends.lower_llm(ref_configs.get_config(arch), batch=2,
                                   seq=2048)
    assert _layers(got) == _layers(want)
    assert _layers(expand_training_graph(got)) == \
        _layers(Workload(arch, training=True, batch=2, seq=2048).layers())


@pytest.mark.parametrize("bad", [dict(batch=0), dict(seq=0), dict(seq=-3)])
def test_lower_llm_rejects_empty_token_counts(bad):
    cfg = configs.get_config("smollm-360m")
    with pytest.raises(ValueError, match="must be positive"):
        frontends.lower_llm(cfg, **bad)


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_both_spellings_resolve(arch):
    alias = configs._MODULES[arch]
    a = Workload(arch, seq=64).layers()
    b = Workload(alias, seq=64).layers()
    assert _layers(a) == _layers(b)
    assert frontends.resolve_llm_config(alias) == configs.get_config(arch)


@pytest.mark.parametrize("name", ["qwen3_0_6", "not_a_net", "resnet-50"])
def test_unknown_name_raises_value_error_with_listing(name):
    with pytest.raises(ValueError) as got:
        Workload(name).layers()
    with pytest.raises(ValueError) as want:
        RefWorkload(name).layers()
    assert str(got.value) == str(want.value)
    msg = str(got.value)
    assert "resnet50" in msg and "qwen3_0_6b" in msg and "gemma3-27b" in msg


def test_seq_rejected_for_cnn_and_layer_lists():
    with pytest.raises(ValueError, match="seq applies"):
        Workload(net="resnet50", seq=128).layers()
    layers = Workload("qwen3_0_6b", seq=16).layers()
    with pytest.raises(ValueError, match="seq applies"):
        Workload(net=tuple(layers), seq=128)


# ---------------------------------------------------------------------------
# pricing: bit-identical to the JAX package's numpy engine
# ---------------------------------------------------------------------------

def _pt(p):
    return (p.sizes_kb, p.bws, p.cycles)


def _pts(points):
    return [_pt(p) for p in points]


def _summary(res):
    return {
        "best": _pt(res.best), "worst": _pt(res.worst),
        "improvement": res.improvement, "objective": res.objective,
        "points": _pts(res.points), "within_15": _pts(res.within(0.15)),
        "pareto": _pts(res.pareto()),
        "min_sram": _pt(res.economic_min_sram()),
        "energy_report": res.energy_report(),
        "phases": res.phase_breakdown().cycles,
        "size_tuples": res.grid.size_tuples, "bw_tuples": res.grid.bw_tuples,
    }


@pytest.fixture(scope="module")
def priced():
    """Every fixture, objective and engine once: the JAX package's numpy
    engine and scalar walk, and the port's three backends on the CPU."""
    out = {}
    for key, (name, training, seq) in FIXTURES.items():
        hw = (TRAIN_PRESETS if training else INFER_PRESETS)[16]
        ref_hw = (REF_TRAIN if training else REF_INFER)[16]
        ref_wl = RefWorkload(name, training=training, seq=seq)
        wl = Workload(name, training=training, seq=seq)
        ref = RefStudy(ref_hw, sizes=GRID, bws=BWG, backend="numpy")
        ports = {b: Study(hw, sizes=GRID, bws=BWG, backend=b, device="cpu")
                 for b in DSE_BACKENDS}
        for obj in OBJECTIVES:
            out[key, "ref", obj] = ref.search(ref_wl, 512, 64, objective=obj)
            for b, study in ports.items():
                out[key, b, obj] = study.search(wl, 512, 64, objective=obj)
        out[key, "scalar"] = search_reference(ref_hw, ref_wl.layers(), 512,
                                              64, sizes=GRID, bws=BWG)
    return out


@pytest.mark.parametrize("backend", DSE_BACKENDS)
@pytest.mark.parametrize("obj", OBJECTIVES)
@pytest.mark.parametrize("fixture", FIXTURES)
def test_llm_search_matches_numpy_engine(priced, fixture, obj, backend):
    want, got = priced[fixture, "ref", obj], priced[fixture, backend, obj]
    sa, sb = _summary(want), _summary(got)
    for key in sa:
        assert sa[key] == sb[key], key
    assert got.grid.costs.dtype == np.int64
    assert np.array_equal(got.grid.costs, want.grid.costs)
    if obj == "cycles":
        assert got.grid_scores is None and want.grid_scores is None
    else:
        assert got.grid_scores.dtype == np.float64
        assert np.array_equal(got.grid_scores, want.grid_scores)


@pytest.mark.parametrize("backend", DSE_BACKENDS)
@pytest.mark.parametrize("fixture", FIXTURES)
def test_llm_search_matches_scalar_reference(priced, fixture, backend):
    ref, got = priced[fixture, "scalar"], priced[fixture, backend, "cycles"]
    assert _pt(got.best) == _pt(ref.best)
    assert _pt(got.worst) == _pt(ref.worst)
    assert _pts(got.within(0.15)) == _pts(ref.within(0.15))
    pb = got.phase_breakdown()
    assert pb.total == ref.best.cycles
    assert pb.conv_cycles == pb.gemm_cycles > 0     # zero-conv workload
    assert pb.nonconv_cycles > 0

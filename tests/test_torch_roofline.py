"""The port's roofline (``repro_torch.launch.roofline`` and
``core/gpu_model.py::RooflineTerms``, ``model_flops``) against the JAX
package's, on the CPU:

* the two collective-parser cases of ``tests/test_costmodel.py`` on the
  port's own copy of the parser, and both parsers equal on those strings
  and on the optimized HLO of a sharded JAX program whose collectives
  sit inside a scanned loop, compiled on 4 placeholder CPU devices in a
  subprocess;
* ``RooflineTerms`` on the H100's constants: the three terms, the bound,
  the step time and ``as_dict``'s keys as the TPU model's; a ``None``
  collective term left out of the bound and step time;
* ``analyze``: the reference's keys (less ``xla_*_body_once``) from a
  ``Cost``;
* ``count_params`` equal to the JAX package's for all ten configs at
  full size (total and active).

Every comparison is exact, but the terms' times (float arithmetic on the
same inputs, 1e-15 relative).
"""
import json
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from test_torch_ranks import ROOT, env  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import tpu_model  # noqa: E402
from repro.launch import roofline as JRL  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core import gpu_model  # noqa: E402
from repro_torch.core.gpu_model import RooflineTerms, model_flops  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402
from repro_torch.launch.costmodel import Cost  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

HLO = """
HloModule test

%body.1 (p: (s32[], f32[64,128])) -> (s32[], f32[64,128]) {
  %ag = f32[64,128]{1,0} all-gather(%x), channel_id=1, replica_groups=[2,4]<=[8], dimensions={1}
  ROOT %t = (s32[], f32[64,128]) tuple(%i, %ag)
}

%cond.2 (p: (s32[], f32[64,128])) -> pred[] {
  %c = s32[] constant(12)
  ROOT %cmp = pred[] compare(%i, %c), direction=LT
}

ENTRY %main (a: f32[64,128]) -> f32[] {
  %w = (s32[], f32[64,128]) while(%init), condition=%cond.2, body=%body.1
  ROOT %ar = f32[] all-reduce(%s), channel_id=9, replica_groups={}, to_apply=%add
}
"""

TUPLE = """
ENTRY %main (a: f32[8]) -> f32[8] {
  %ar = (f32[8]{0}, f32[16]{0}) all-reduce-start(%a, %b), channel_id=1
  %d = (f32[8]{0}, f32[16]{0}) all-reduce-done(%ar)
}
"""


def test_collective_parser_multiplies_trips():
    total, kinds = RL.collective_bytes(HLO)
    body_bytes = 64 * 128 * 4
    assert kinds["all-gather"] == body_bytes * 12
    assert kinds["all-reduce"] == 4
    assert total == body_bytes * 12 + 4


def test_collective_parser_tuple_output():
    total, kinds = RL.collective_bytes(TUPLE)
    assert total == (8 + 16) * 4      # -start counted once, -done skipped


@pytest.mark.parametrize("text", [HLO, TUPLE, "", "ENTRY %m () -> f32[] {\n}"])
def test_collective_parser_equals_the_reference(text):
    assert RL.collective_bytes(text) == JRL.collective_bytes(text)


COMPILED = """
import json, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(jax.devices()[:4], ("i",))

def step(c, w):
    g = jax.lax.with_sharding_constraint(c @ w, NamedSharding(mesh, P()))
    return g * 0.5, jnp.sum(g)

def f(x, w):
    y, s = jax.lax.scan(lambda c, _: step(c, w), x, None, length=5)
    return y, s

x = jax.ShapeDtypeStruct((64, 32), jnp.float32,
                         sharding=NamedSharding(mesh, P("i", None)))
w = jax.ShapeDtypeStruct((32, 32), jnp.float32,
                         sharding=NamedSharding(mesh, P(None, "i")))
text = jax.jit(f, out_shardings=(NamedSharding(mesh, P("i", None)),
                                 NamedSharding(mesh, P()))
               ).lower(x, w).compile().as_text()
print("HLO " + json.dumps(text))
"""


@pytest.fixture(scope="module")
def compiled_hlo():
    res = subprocess.run(
        [sys.executable, "-c", COMPILED], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env=env(XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("HLO ")]
    assert lines, res.stdout + res.stderr
    return json.loads(lines[-1][len("HLO "):])


def test_collective_parser_on_compiled_hlo(compiled_hlo):
    got = RL.collective_bytes(compiled_hlo)
    assert got == JRL.collective_bytes(compiled_hlo)
    assert got[0] > 0 and "while" in compiled_hlo, compiled_hlo


# ---- the H100 roofline ----------------------------------------------------------------

def test_roofline_terms_on_the_h100():
    t = RooflineTerms(flops=1e15, hbm_bytes=6.7e12, collective_bytes=9e11,
                      chips=4)
    assert t.t_compute == pytest.approx(1e15 / (4 * 989e12), rel=1e-15)
    assert t.t_memory == pytest.approx(6.7e12 / (4 * 3.35e12), rel=1e-15)
    assert t.t_collective == pytest.approx(9e11 / (4 * 450e9), rel=1e-15)
    assert gpu_model.NVLINK_BW == 450e9
    assert t.bound == "memory" and t.step_time == t.t_memory
    assert t.roofline_fraction == pytest.approx(t.t_compute / t.t_memory)
    ref = tpu_model.RooflineTerms(flops=1e15, hbm_bytes=6.7e12,
                                  collective_bytes=9e11, chips=4)
    assert list(t.as_dict()) == list(ref.as_dict())
    assert model_flops(10, 7, True) == tpu_model.model_flops(10, 7, True)
    assert model_flops(10, 7, False) == tpu_model.model_flops(10, 7, False)


def test_roofline_without_a_collective_term():
    t = RooflineTerms(flops=1e15, hbm_bytes=1e9, collective_bytes=None,
                      chips=1)
    assert t.t_collective is None
    assert t.bound == "compute"
    assert t.step_time == t.t_compute
    d = t.as_dict()
    assert d["t_collective_s"] is None and d["collective_bytes"] is None
    # the collective term still bounds when it is given and largest
    t = RooflineTerms(flops=1.0, hbm_bytes=1.0, collective_bytes=1e12,
                      chips=1)
    assert t.bound == "collective"


def test_analyze_gives_the_reference_keys():
    cost = Cost(flops=3e15, bytes=2e13, gemm_flops=2.9e15)
    got = RL.analyze(cost, 256, 600_000_000, 256 * 4096, True)
    want_keys = set(tpu_model.RooflineTerms(1, 1, 1, 1).as_dict()) | {
        "model_flops", "model_flops_ratio", "collective_by_kind"}
    assert want_keys <= set(got)
    assert not any(k.startswith("xla_") for k in got)
    assert got["model_flops"] == 6.0 * 600_000_000 * 256 * 4096
    assert got["model_flops_ratio"] == got["model_flops"] / 3e15
    assert got["t_collective_s"] is None and got["bound"] == "memory"
    assert got["gemm_flops"] == 2.9e15
    given = RL.analyze(cost, 4, 1, 1, False, collective_bytes=1e9)
    assert given["t_collective_s"] == 1e9 / (4 * 450e9)
    assert given["collective_by_kind"] is None


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_equals_the_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    frac = 1.0
    if cfg.n_experts:
        frac = (cfg.top_k + (1 if cfg.shared_expert else 0)) / cfg.n_experts
    got = RL.count_params(Model(cfg).param_defs(), {"expert_frac": frac})
    want = JRL.count_params(JModel(jcfg).param_defs(),
                            {"expert_frac": frac})
    assert got == want
    assert RL.count_params(Model(cfg).param_defs()) == JRL.count_params(
        JModel(jcfg).param_defs())

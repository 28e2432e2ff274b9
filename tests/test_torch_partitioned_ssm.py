"""The partitioned SSD mixer (``models/ssm.py`` on ``DTensor``s: the packed
in-projection made whole on ``model``, the conv over every channel, the
chunk loop and the decode recurrence on each rank's heads, the gated
norm's sum of squares summed over the heads' ranks) against the port's
unpartitioned route and the JAX package's ``jax.jit(in_shardings=...)``
steps, on the CPU.

The harness of ``tests/test_torch_partitioned.py`` (``run_cases``): four
``gloo`` ranks on a (2, 2) ``("data", "model")`` mesh, float32,
``PROD_RULES`` sized to it, the same numpy weights and tokens (4 x 12)
through both routes of the port and, in a subprocess with 4 forced host
devices, the reference's jitted sharded steps.  The cases, on reduced
mamba2-130m (d_model 64, d_inner 128, state 16, 8 heads of 16):

* ``mamba2``: the 8 heads split 4/4; the in-projection's 296 columns
  split at 148, inside x (columns 128-255), and the conv's 160 channels
  (x, B, C) at 80, inside x too;
* ``mamba2_heads_whole``: d_model 96 and heads of 64, so 3 heads and a
  419-column in-projection, neither of which divides 2 -- the
  production case of 24 heads and 3,352 columns on a 16-way ``model``:
  every rank runs every head;
* ``mamba2_remat``: under remat ``full`` (loss, gradients, the step).

The models' own chunk of 256 leaves those 12-token prefills at one
chunk, so ``test_chunks_carry_the_state_on_local_heads`` holds
``apply_ssm(..., chunk=4)`` alone on a 12-token prefill with an incoming
state (3 chunks carrying the state on each rank's heads) against the
unpartitioned call and the reference's ``apply_ssm(chunk=4)`` jitted
with ``in_shardings``: the output and both new state leaves.

Held in ``tests/test_torch_partitioned.py``'s ``LIMITS``.
"""
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_decode import numpy_params  # noqa: E402
from test_torch_partitioned import (LIMITS, _jcfg, hold_jax,  # noqa: E402
                                    hold_unpartitioned, run_cases)
from test_torch_ranks import ROOT, env, run_ranks  # noqa: E402

MAMBA2 = "mamba2-130m"
CASES = {
    "mamba2": (MAMBA2, {}),
    "mamba2_heads_whole": (MAMBA2, {"d_model": 96, "ssm_head_dim": 64}),
    "mamba2_remat": (MAMBA2, {"remat": True, "remat_policy": "full"}),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("partitioned_ssm")
    return tmp, run_cases(tmp, CASES, timeout=300)


@pytest.mark.parametrize("name", CASES)
def test_partitioned_ssd_equals_unpartitioned(runs, name):
    _, ranks = runs
    hold_unpartitioned(ranks, name)
    assert ("prefill" in ranks[0][name]["err"]) == (name != "mamba2_remat")


@pytest.mark.parametrize("name", CASES)
def test_partitioned_ssd_equals_the_jax_sharded_step(runs, name):
    tmp, _ = runs
    hold_jax(tmp, name)


def test_the_cases_split_what_they_say():
    """The reduced config's in-projection and conv split inside x on 2
    ranks; the heads-whole case's heads and columns do not divide 2."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.ssm import ssm_dims
    for name, want in (("mamba2", (128, 8, 296, 160)),
                       ("mamba2_heads_whole", (192, 3, 419, 224))):
        kw = CASES[name][1]
        cfg = reduced(get_config(MAMBA2)).replace(**kw)
        di, h, n = ssm_dims(cfg)
        assert (di, h, 2 * di + 2 * n + h, di + 2 * n) == want
    # the in-projection is [z, x, B, C, dt], the conv's input [x, B, C]
    di = 128
    assert di < 296 // 2 < 2 * di and 0 < 160 // 2 < di
    assert 3 % 2 and 419 % 2


# apply_ssm alone, chunk 4, a 12-token prefill over an incoming state
LAYER_BATCH, LAYER_SEQ, LAYER_CHUNK = 4, 12, 4

LAYER_PORT = """
import numpy as np
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import ssm
from repro_torch.models.common import (P, PROD_RULES, param_specs, place,
                                       placements, with_axis_sizes)

DIR = os.environ["CASE_DIR"]


def full(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


def rel(a, b):
    a, b = full(a).double(), full(b).double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def main(rank, world):
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    rules = with_axis_sizes(PROD_RULES, mesh)
    cfg = reduced(get_config("mamba2-130m")).replace(dtype=torch.float32)
    data = np.load(f"{DIR}/layer.npz")
    p = {k[2:]: torch.from_numpy(data[k]) for k in data.files
         if k.startswith("p/")}
    u = torch.from_numpy(data["u"])
    state = {k: torch.from_numpy(data[k]) for k in ("ssm", "conv")}
    want_state = {k: v.clone() for k, v in state.items()}
    want, _ = ssm.apply_ssm(cfg, p, u, None, state=want_state, chunk=%d)
    specs = param_specs(ssm.ssm_defs(cfg), rules)
    dp = place(p, {k: (mesh, placements(s, mesh)) for k, s in specs.items()})
    du = place(u, (mesh, placements(P("data", None, None), mesh)))
    dstate = {
        "ssm": place(state["ssm"].clone(), (mesh, placements(
            P("data", "model", None, None), mesh))),
        "conv": place(state["conv"].clone(), (mesh, placements(
            P("data", None, None), mesh)))}
    impl = ops.partitioned(None, mesh, rules)
    got, _ = ssm.apply_ssm(cfg, dp, du, rules, state=dstate, chunk=%d,
                           impl=impl)
    err = {"y": rel(got, want), **{k: rel(dstate[k], want_state[k])
                                   for k in dstate}}
    keep = {"y": full(got), **{k: full(v) for k, v in dstate.items()}}
    if rank == 0:
        np.savez(f"{DIR}/layer.port.npz",
                 **{k: v.numpy() for k, v in keep.items()})
    return {"err": err, "local_ssm": list(dstate["ssm"].to_local().shape),
            "y": [str(q) for q in got.placements]}
""" % (LAYER_CHUNK, LAYER_CHUNK)

LAYER_JAX = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config, reduced
from repro.launch.mesh import make_mesh
from repro.models import ssm
from repro.models.common import PROD_RULES, param_specs, with_axis_sizes

DIR = sys.argv[1]
mesh = make_mesh((2, 2), ("data", "model"))
rules = with_axis_sizes(PROD_RULES, mesh)
cfg = reduced(get_config("mamba2-130m")).replace(dtype=jnp.float32)
data = np.load(f"{DIR}/layer.npz")
p = {k[2:]: jnp.asarray(data[k]) for k in data.files if k.startswith("p/")}
specs = param_specs(ssm.ssm_defs(cfg), rules)
shardings = (
    {k: NamedSharding(mesh, s) for k, s in specs.items()},
    NamedSharding(mesh, P("data", None, None)),
    {"ssm": NamedSharding(mesh, P("data", "model", None, None)),
     "conv": NamedSharding(mesh, P("data", None, None))})
with mesh:
    y, state = jax.jit(
        lambda p, u, st: ssm.apply_ssm(cfg, p, u, rules, state=st,
                                       chunk=%d),
        in_shardings=shardings)(
        p, jnp.asarray(data["u"]),
        {k: jnp.asarray(data[k]) for k in ("ssm", "conv")})
np.savez(f"{DIR}/layer.jax.npz", y=np.asarray(y),
         **{k: np.asarray(v) for k, v in state.items()})
print("JAX done")
""" % LAYER_CHUNK


@pytest.fixture(scope="module")
def layer(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("partitioned_ssm_layer")
    jcfg = _jcfg(MAMBA2, {})
    params = numpy_params(jcfg)["blk0"]["ssm"]
    rng = np.random.default_rng(3)
    di, h, n = 128, 8, 16
    b, s = LAYER_BATCH, LAYER_SEQ

    def draw(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    np.savez(tmp / "layer.npz", u=draw(b, s, jcfg.d_model),
             ssm=draw(b, h, jcfg.ssm_head_dim, n, scale=0.5),
             conv=draw(b, jcfg.conv_width - 1, di + 2 * n),
             **{f"p/{k}": np.asarray(v[0]) for k, v in params.items()})
    jax_run = subprocess.Popen(
        [sys.executable, "-c", LAYER_JAX, str(tmp)], cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=env(XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    try:
        ranks = run_ranks(LAYER_PORT, 4, tmp, timeout=120,
                          CASE_DIR=str(tmp))
        out, err = jax_run.communicate(timeout=120)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.communicate()
    assert jax_run.returncode == 0 and "JAX done" in out, err[-3000:]
    return tmp, ranks


def test_chunks_carry_the_state_on_local_heads(layer):
    """Three chunks of 4 with an incoming state, each rank on its 4 of
    the 8 heads: the output (``Partial`` over ``model`` from ``w_out``'s
    row-parallel product) and the new ``ssm`` and ``conv`` states within
    ``LIMITS["cache"]`` of the unpartitioned call on every rank and of
    the reference's jitted sharded call."""
    tmp, ranks = layer
    limit = LIMITS["cache"]
    for r in ranks:
        assert max(r["err"].values()) <= limit, r["err"]
        assert r["local_ssm"] == [LAYER_BATCH // 2, 4, 16, 16]
        assert r["y"] == ["S(0)", "P(sum)"]
    with np.load(tmp / "layer.port.npz") as got, \
            np.load(tmp / "layer.jax.npz") as want:
        assert sorted(got.files) == sorted(want.files) == ["conv", "ssm",
                                                           "y"]
        for key in want.files:
            g, w = got[key].astype(np.float64), want[key].astype(np.float64)
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert err <= limit, (key, err)

"""The port's GPipe pipeline (``repro_torch.distributed.pipeline``) against
sequential execution and against the JAX package's ``pipeline_apply``:
the two tests of ``tests/test_pipeline_parallel.py`` on the port, over 4
``gloo`` ranks on the CPU (S 4 stages, B 8, D 16, M 4 microbatches,
``tanh(h @ w)``), with the stage weights as a stack every rank holds
and as a ``DTensor`` sharded over the stages.  The forward is held
within 1e-5 of the sequential result and of JAX's (a subprocess with 4
forced host devices, on the same numpy weights), every stage's
gradient within 1e-4 of the sequential one.
"""
import json
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from test_torch_ranks import ROOT, env, run_ranks  # noqa: E402

from repro_torch.distributed.pipeline import bubble_fraction  # noqa: E402

S, B, D, M = 4, 8, 16, 4

DATA = f"""
import numpy as np
S, B, D, M = {S}, {B}, {D}, {M}
rng = np.random.default_rng(0)
WS = (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32)
X = rng.standard_normal((B, D)).astype(np.float32)
"""

PORT = DATA + """
from torch.distributed.tensor import Shard, distribute_tensor
from repro_torch.distributed.pipeline import pipeline_apply
from repro_torch.launch.mesh import make_mesh


def stage_fn(w, h):
    return torch.tanh(h @ w)


def main(rank, world):
    mesh = make_mesh((S,), ("stage",), device_type="cpu")
    x = torch.from_numpy(X)
    seq_ws = torch.from_numpy(WS).requires_grad_()
    h = x
    for i in range(S):
        h = stage_fn(seq_ws[i], h)
    (h ** 2).sum().backward()
    out = {"seq": h.tolist(), "seq_grad": seq_ws.grad[rank].tolist()}
    stacked = torch.from_numpy(WS).requires_grad_()
    sharded = distribute_tensor(torch.from_numpy(WS), mesh, [Shard(0)]
                                ).requires_grad_()
    for name, ws in (("stacked", stacked), ("sharded", sharded)):
        y = pipeline_apply(stage_fn, ws, x, n_micro=M, mesh=mesh)
        (y ** 2).sum().backward()
        grad = ws.grad.to_local()[0] if name == "sharded" else \\
            ws.grad[rank]
        others = [] if name == "sharded" else \\
            [float(ws.grad[i].abs().max()) for i in range(S) if i != rank]
        out[name] = {"y": y.tolist(), "grad": grad.tolist(),
                     "other_rows": others}
    return out
"""

JAX = DATA + """
import jax, jax.numpy as jnp
from repro.distributed.pipeline import pipeline_apply
from repro.launch.mesh import make_mesh
mesh = make_mesh((4,), ("stage",))
y = pipeline_apply(lambda w, h: jnp.tanh(h @ w), jnp.asarray(WS),
                   jnp.asarray(X), n_micro=M, mesh=mesh)
print("JAX_Y " + json.dumps(np.asarray(y).tolist()))
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(PORT, S, tmp_path_factory.mktemp("pipeline"))


@pytest.fixture(scope="module")
def jax_y():
    res = subprocess.run(
        [sys.executable, "-c", "import json\n" + JAX], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env=env(XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("JAX_Y ")]
    assert lines, res.stdout + res.stderr
    return np.array(json.loads(lines[-1][len("JAX_Y "):]))


@pytest.mark.parametrize("layout", ["stacked", "sharded"])
def test_pipeline_matches_sequential(ranks, jax_y, layout):
    seq = np.array(ranks[0]["seq"])
    for r in ranks:
        y = np.array(r[layout]["y"])
        assert y.shape == (B, D)
        assert np.abs(y - seq).max() < 1e-5
        assert np.abs(y - jax_y).max() < 1e-5
    for rank, r in enumerate(ranks):
        gerr = np.abs(np.array(r[layout]["grad"])
                      - np.array(r["seq_grad"])).max()
        assert gerr < 1e-4, (rank, gerr)
        # a stage's gradient reaches its own slice of the stack only
        assert r[layout]["other_rows"] in ([], [0.0] * (S - 1))


def test_bubble_fraction():
    assert bubble_fraction(n_micro=1, n_stages=4) == pytest.approx(0.75)
    assert bubble_fraction(n_micro=12, n_stages=4) == pytest.approx(3 / 15)
    assert bubble_fraction(n_micro=100, n_stages=1) == 0.0

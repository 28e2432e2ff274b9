"""The port's checkpoint manager (``repro_torch.checkpoint.manager``)
against the JAX package's ``repro.checkpoint.manager``: the behaviours
``tests/test_checkpoint.py`` holds there (round trip, retention,
atomicity, a missing step raising, a resumed run continuing the
uninterrupted one), and restores across the two packages both ways,
with a bfloat16 leaf and the int32 optimizer step, bit for bit."""
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_ranks import ROOT, env  # noqa: E402

from repro.checkpoint import manager as jmanager  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.interop import from_numpy, to_numpy  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.common import TensorSpec  # noqa: E402

JManager = jmanager.CheckpointManager


def _arrays(seed=0):
    """The numpy leaves of one state: f32, bf16 (an ml_dtypes array), an
    int32 scalar."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.standard_normal((8, 8)).astype(np.float32),
                   "b": (rng.standard_normal(8) * 3).astype(jnp.bfloat16)},
        "opt": {"m": {"w": np.ones((8, 8), np.float32),
                      "b": np.zeros(8, np.float32)},
                "step": np.asarray(7, np.int32)},
    }


def _state(seed=0):
    return jax.tree_util.tree_map(from_numpy, _arrays(seed))


def _jstate(seed=0):
    return jax.tree_util.tree_map(jnp.asarray, _arrays(seed))


def _flat(tree):
    return jax.tree_util.tree_leaves(tree)


def _same_bits(got, want):
    """Every leaf: the same dtype name, shape and bits."""
    for g, w in zip(_flat(got), _flat(want)):
        g = to_numpy(g) if isinstance(g, torch.Tensor) else np.asarray(g)
        w = to_numpy(w) if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.reshape(-1).view(np.uint8),
                                      w.reshape(-1).view(np.uint8))


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _state()
    mgr.save(10, state, {"pipeline": {"step": 10}, "note": "x"})
    assert mgr.latest_step() == 10
    template = jax.tree_util.tree_map(
        lambda t: TensorSpec(tuple(t.shape), t.dtype), state)
    restored, extra = mgr.restore(10, template)
    assert extra == {"pipeline": {"step": 10}, "note": "x"}
    assert restored["params"]["b"].dtype == torch.bfloat16
    assert restored["opt"]["step"].dtype == torch.int32
    _same_bits(restored, state)


def test_restore_into_tensors_takes_their_dtype_and_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    template = _state(seed=5)
    template["params"]["w"] = template["params"]["w"].double()
    restored, _ = mgr.restore(1, template)
    assert restored["params"]["w"].dtype == torch.float64
    np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                  _arrays()["params"]["w"])
    restored, _ = mgr.restore(1, _state(), device="cpu")
    assert all(t.device.type == "cpu" for t in _flat(restored))


def test_restore_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    template = _state()
    template["params"]["w"] = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="params/w"):
        mgr.restore(1, template)


def test_manifest_matches_the_jax_format(tmp_path):
    CheckpointManager(str(tmp_path / "t")).save(3, _state(), {"a": 1})
    JManager(str(tmp_path / "j")).save(3, _jstate(), {"a": 1})
    for name in ("t", "j"):
        assert (tmp_path / name / "step_0000000003" / "arrays.npz").exists()
    got = json.loads((tmp_path / "t" / "step_0000000003" /
                      "manifest.json").read_text())
    want = json.loads((tmp_path / "j" / "step_0000000003" /
                       "manifest.json").read_text())
    assert got == want
    with np.load(tmp_path / "t" / "step_0000000003" / "arrays.npz") as t, \
            np.load(tmp_path / "j" / "step_0000000003" / "arrays.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        assert "params__b" in t.files
        for k in t.files:
            assert t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k])


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    JManager(str(tmp_path)).save(4, _jstate(1), {"train_step": 4})
    restored, extra = CheckpointManager(str(tmp_path)).restore(4, _state())
    assert extra == {"train_step": 4}
    _same_bits(restored, _state(1))


def test_port_checkpoint_restores_in_jax(tmp_path):
    CheckpointManager(str(tmp_path)).save(4, _state(2), {"train_step": 4})
    restored, extra = JManager(str(tmp_path)).restore(4, _jstate())
    assert extra == {"train_step": 4}
    assert restored["params"]["b"].dtype == jnp.bfloat16
    assert restored["opt"]["step"].dtype == jnp.int32
    _same_bits(restored, _jstate(2))


def test_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s))
    assert mgr.all_steps() == [3, 4]
    (tmp_path / "step_bogus").mkdir()
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4


def test_atomic_no_tmp_left(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _state())
    mgr.save(5, _state(1))               # a re-save of the same step
    assert not list(tmp_path.glob("tmp.*"))
    assert (tmp_path / "step_0000000005" / "manifest.json").exists()
    _same_bits(mgr.restore(5, _state())[0], _state(1))


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(99, _state())


def test_save_on_signal_flushes_and_exits(tmp_path, monkeypatch):
    import signal
    handlers = {}
    monkeypatch.setattr(signal, "signal",
                        lambda sig, fn: handlers.__setitem__(sig, fn))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_on_signal(lambda: (6, _state(), {"why": "sigterm"}))
    with pytest.raises(SystemExit) as exc:
        handlers[signal.SIGTERM](signal.SIGTERM, None)
    assert exc.value.code == 128 + signal.SIGTERM
    assert mgr.latest_step() == 6
    assert mgr.restore(6, _state())[1] == {"why": "sigterm"}


def test_train_resume_continues(tmp_path):
    """Kill-and-resume: a resumed run continues from the checkpoint and
    gives the losses of an uninterrupted run (the step is deterministic
    on the CPU; the JAX test's tolerance)."""
    kw = dict(steps=6, batch=2, seq=16, ckpt_every=3, log=lambda *a: None,
              device="cpu")
    full = train.train_loop("smollm-360m", ckpt_dir=str(tmp_path / "a"),
                            **kw)
    train.train_loop("smollm-360m", ckpt_dir=str(tmp_path / "b"),
                     stop_after=3, **kw)
    part2 = train.train_loop("smollm-360m", ckpt_dir=str(tmp_path / "b"),
                             resume=True, **kw)
    assert len(part2["losses"]) == 3
    np.testing.assert_allclose(full["losses"][3:], part2["losses"],
                               rtol=2e-4, atol=2e-4)
    _same_bits(part2["state"], full["state"])


# ---- restores onto a DeviceMesh ---------------------------------------------

# Four ``gloo`` ranks (``test_torch_ranks.run_ranks``).  A reduced
# Qwen3-0.6B state (bfloat16 parameters, float32 AdamW moments, the int32
# step) saved unsharded by the port and by the JAX package (in a process
# of its own) is restored with ``shardings=make_state_shardings(...)``
# onto a (2, 2) and a (4, 1) ``("data", "model")`` mesh: every leaf a
# DTensor laid out as asked, bit-equal to the saved arrays through
# ``full_tensor``.  One partitioned AdamW step from the restored state
# equals, bit for bit, the step from the same state placed directly; and
# the placed state saved again (each leaf gathered, rank 0 writing)
# restores unsharded to the same bits.
MESH = """
import os
import numpy as np
from torch.distributed.tensor import DTensor
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.interop import from_stored
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import (PROD_RULES, TensorSpec, place,
                                       tree_map, with_axis_sizes)
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamW, constant_schedule

DIR = os.environ["CKPT_DIR"]


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def saved():
    with np.load(f"{DIR}/arrays.npz") as data:
        return {k.replace("__", "/"): from_stored(
            data[k], "bfloat16" if k.startswith("params") else
            str(data[k].dtype)) for k in data.files}


def same(a, b):
    a = a.full_tensor() if isinstance(a, DTensor) else a
    return a.dtype == b.dtype and torch.equal(a.view(torch.uint8)
                                              if a.dim() else a, b.view(
        torch.uint8) if b.dim() else b)


def main(rank, world):
    cfg = reduced(get_config("qwen3-0.6b")).replace(vocab_size=512)
    opt = AdamW(schedule=constant_schedule(1e-3))
    want = saved()
    out = {}
    template = {"params": Model(cfg).abstract()}
    template["opt"] = {"m": tree_map(lambda s: TensorSpec(
        s.shape, torch.float32), template["params"]),
        "v": tree_map(lambda s: TensorSpec(s.shape, torch.float32),
                      template["params"]),
        "step": TensorSpec((), torch.int32)}
    states = {}
    for shape in ((2, 2), (4, 1)):
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        rules = with_axis_sizes(PROD_RULES, mesh)
        model = Model(cfg, impl=ops.partitioned(None, mesh, rules))
        sh = train.make_state_shardings(model, opt, rules, mesh)
        for writer in ("port", "jax"):
            got, extra = CheckpointManager(f"{DIR}/{writer}").restore(
                5, template, shardings=sh)
            pairs = flat(sh)
            ok = placed = 0
            for key, leaf in flat(got).items():
                ok += same(leaf, want[key])
                placed += (isinstance(leaf, DTensor) and tuple(
                    leaf.placements) == tuple(pairs[key][1]))
            out[f"{writer}{shape}"] = [ok, placed, len(want), extra]
            states[(writer, shape)] = (got, model, sh, mesh, rules)
    got, model, sh, mesh, rules = states[("port", (2, 2))]
    plain = {k: v for k, v in want.items()}
    direct = place(_nested(plain), sh)
    tokens = torch.from_numpy(np.load(f"{DIR}/tokens.npy"))
    batch = place({"tokens": tokens}, train.batch_shardings(
        mesh, rules, {"tokens": tokens}))
    step = train.make_train_step(model, opt, rules)
    results = []
    for state in (got, direct):
        state = {"params": train.trainable(state["params"]),
                 "opt": state["opt"]}
        new, metrics = step(state, batch)
        results.append((flat(new), float(metrics["loss"].full_tensor())))
    out["step_equal"] = all(same(a, b.full_tensor())
                            for a, b in zip(results[0][0].values(),
                                            results[1][0].values()))
    out["losses"] = [results[0][1], results[1][1]]
    CheckpointManager(f"{DIR}/placed").save(6, got, {"saved": "placed"})
    back, extra = CheckpointManager(f"{DIR}/placed").restore(6, template)
    out["placed_save"] = [sum(same(leaf, want[key]) for key, leaf in
                              flat(back).items()), len(want), extra]
    return out


def _nested(flat_tree):
    out = {}
    for key, value in flat_tree.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out
"""


JAX_SAVE = """
import sys
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
from repro.checkpoint.manager import CheckpointManager
tmp = sys.argv[1]
with np.load(f"{tmp}/arrays.npz") as d:
    flat = {k: d[k] for k in d.files}
tree = {}
for key, arr in flat.items():
    *path, leaf = key.split("__")
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = (arr.view(ml_dtypes.bfloat16) if key.startswith("params")
                  else arr)
CheckpointManager(f"{tmp}/jax").save(
    5, jax.tree_util.tree_map(jnp.asarray, tree), {"writer": "jax"})
"""


@pytest.fixture(scope="module")
def on_meshes(tmp_path_factory):
    from test_torch_ranks import run_ranks
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import Model
    tmp = tmp_path_factory.mktemp("mesh_restore")
    cfg = reduced(get_config("qwen3-0.6b")).replace(vocab_size=512)
    rng = np.random.default_rng(3)
    params = tree_map(lambda s: (rng.standard_normal(s.shape) * 0.05).astype(
        jnp.bfloat16), Model(cfg).abstract())
    moments = tree_map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), params)
    arrays = {"params": params, "opt": {
        "m": moments, "v": tree_map(np.abs, moments),
        "step": np.asarray(4, np.int32)}}
    CheckpointManager(str(tmp / "port")).save(5, jax.tree_util.tree_map(
        from_numpy, arrays), {"writer": "port"})
    with np.load(tmp / "port" / "step_0000000005" / "arrays.npz") as d:
        np.savez(tmp / "arrays.npz", **{k: d[k] for k in d.files})
    # the JAX package's manager writes the same arrays, in a process of
    # its own
    res = subprocess.run([sys.executable, "-c", JAX_SAVE, str(tmp)],
                         cwd=ROOT, env=env(), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    np.save(tmp / "tokens.npy", np.random.default_rng(4).integers(
        0, 512, (4, 12), dtype=np.int32))
    return run_ranks(MESH, 4, tmp, timeout=180, CKPT_DIR=str(tmp))


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("shape", ["(2, 2)", "(4, 1)"])
def test_restore_onto_a_mesh_is_bit_equal(on_meshes, writer, shape):
    for rank in on_meshes:
        ok, placed, n, extra = rank[f"{writer}{shape}"]
        assert ok == placed == n > 10
        assert extra == {"writer": writer}


def test_a_step_after_the_restore_equals_one_without_it(on_meshes):
    for rank in on_meshes:
        assert rank["step_equal"]
        assert rank["losses"][0] == rank["losses"][1]


def test_placed_state_saves_gathered_and_restores(on_meshes):
    for rank in on_meshes:
        ok, n, extra = rank["placed_save"]
        assert ok == n and extra == {"saved": "placed"}

"""The port's checkpoint manager (``repro_torch.checkpoint.manager``)
against the JAX package's ``repro.checkpoint.manager``: the behaviours
``tests/test_checkpoint.py`` holds there (round trip, retention,
atomicity, a missing step raising, a resumed run continuing the
uninterrupted one), and restores across the two packages both ways,
with a bfloat16 leaf and the int32 optimizer step, bit for bit."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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

"""The port's optimizer pieces (``repro_torch.optim``) against the JAX
package's ``repro.optim.optimizers``: the schedules, the global norm and
its clipping, and ``SGDM`` over three steps, on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.interop import from_numpy  # noqa: E402

SHAPES = {"conv.w": (3, 3, 4, 8), "bn.gamma": (8,), "bn.beta": (8,),
          "fc.b": (10,)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s, dtype=np.float32) * np.float32(scale)
            for k, s in SHAPES.items()}


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or dict(rtol=1e-6, atol=1e-7)))


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 60, 100, 150])
def test_cosine_schedule(step):
    want = jopt.cosine_schedule(0.1, 10, 100)(step)
    got = topt.cosine_schedule(0.1, 10, 100)(torch.tensor(step,
                                                          dtype=torch.int32))
    assert got.dtype == torch.float32
    _close(got, want)


def test_constant_schedule():
    got = topt.constant_schedule(0.0125)(torch.tensor(3))
    assert got.dtype == torch.float32
    _close(got, jopt.constant_schedule(0.0125)(3))


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_global_norm_and_clipping(max_norm):
    tree = _tree(1)
    _close(topt.global_norm({k: from_numpy(v) for k, v in tree.items()}),
           jopt.global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    got, gn = topt.clip_by_global_norm(
        {k: from_numpy(v) for k, v in tree.items()}, max_norm)
    want, wn = jopt.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in tree.items()}, max_norm)
    _close(gn, wn)
    for k in tree:
        _close(got[k], want[k])


@pytest.mark.parametrize("clip_norm", [0.0, 1.0])
@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_sgdm_three_steps(clip_norm, schedule):
    """Parameters, momentum, step, learning rate and gradient norm after
    each of three steps with fresh gradients."""
    sched = {"constant": lambda m: m.constant_schedule(0.0125),
             "cosine": lambda m: m.cosine_schedule(0.1, 2, 10)}[schedule]
    jo = jopt.SGDM(sched(jopt), momentum=0.9, clip_norm=clip_norm)
    to = topt.SGDM(sched(topt), momentum=0.9, clip_norm=clip_norm)
    params = _tree(2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: from_numpy(v) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        grads = _tree(10 + i, scale=0.5)
        jp, js, jinfo = jo.update({k: jnp.asarray(v)
                                   for k, v in grads.items()}, js, jp)
        tp, ts, tinfo = to.update({k: from_numpy(v)
                                   for k, v in grads.items()}, ts, tp)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        _close(tinfo["lr"], jinfo["lr"])
        _close(tinfo["grad_norm"], jinfo["grad_norm"])
        for k in params:
            assert tp[k].dtype == torch.float32
            assert ts["mom"][k].dtype == torch.float32
            _close(tp[k], jp[k])
            _close(ts["mom"][k], js["mom"][k])


def test_sgdm_keeps_each_parameter_type():
    """A bfloat16 parameter is updated in float32 and stored back in
    bfloat16; its momentum stays float32; the inputs are not changed."""
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    g = {"w": torch.full((4,), 0.5, dtype=torch.bfloat16)}
    opt = topt.SGDM(topt.constant_schedule(0.1))
    state = opt.init(p)
    new, state, _ = opt.update(g, state, p)
    assert new["w"].dtype == torch.bfloat16
    assert state["mom"]["w"].dtype == torch.float32
    assert torch.equal(p["w"], torch.ones(4, dtype=torch.bfloat16))
    assert torch.equal(new["w"], torch.full((4,), 0.95).to(torch.bfloat16))

"""The port's optimizer pieces (``repro_torch.optim``) against the JAX
package's ``repro.optim.optimizers``: the schedules, the global norm and
its clipping, ``SGDM`` over three steps, and ``AdamW`` over three steps
on a nested tree (clipping on and off; float32 and bfloat16 moments,
float32 and bfloat16 parameters), on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.interop import from_numpy, to_numpy  # noqa: E402

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


NESTED = {"embed": {"embedding": (11, 6)},
          "blk0": {"attn": {"wq": (2, 6, 2, 3)}, "norm1": {"scale": (2, 6)}},
          "final_norm": {"scale": (6,)}}


def _nested(seed, scale=1.0, dtype=np.float32):
    rng = np.random.default_rng(seed)

    def make(shapes):
        if isinstance(shapes, dict):
            return {k: make(v) for k, v in shapes.items()}
        return (rng.standard_normal(shapes) * scale).astype(dtype)
    return make(NESTED)


def _pairs(got, want, prefix=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            yield from _pairs(got[k], want[k], f"{prefix}/{k}")
    else:
        yield prefix, got, want


@pytest.mark.parametrize("clip_norm", [1.0, 1e6])
@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("float32", "bfloat16"),
                                    ("bfloat16", "float32")],
                         ids=["f32", "bf16-moments", "bf16-params"])
def test_adamw_three_steps(clip_norm, dtypes):
    """Parameters, both moments, step, learning rate and gradient norm
    after each of three steps with fresh gradients; the moments and the
    parameters in their types.  Float32 to 1e-6 relative, or 1e-6 of the
    leaf's largest element: the global norm's sum over a leaf may differ
    in its last bit (PyTorch's and XLA's reduction orders), and a moment
    that cancels near zero keeps that error as an absolute one.  A
    bfloat16 result to one bfloat16 ulp (2**-7 relative), where a
    float32 difference of an ulp may round the other way."""
    param_dt, mv = dtypes
    jmv = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[mv]
    tmv = {"float32": torch.float32, "bfloat16": torch.bfloat16}[mv]
    np_dt = jnp.bfloat16 if param_dt == "bfloat16" else np.float32
    jo = jopt.AdamW(jopt.cosine_schedule(3e-3, 2, 10), clip_norm=clip_norm,
                    mv_dtype=jmv)
    to = topt.AdamW(topt.cosine_schedule(3e-3, 2, 10), clip_norm=clip_norm,
                    mv_dtype=tmv)
    params = _nested(2, dtype=np_dt)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = jax.tree_util.tree_map(from_numpy, params)
    js, ts = jo.init(jp), to.init(tp)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 0
    for i in range(3):
        grads = _nested(10 + i, scale=2.0, dtype=np_dt)
        jp, js, jinfo = jo.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                  js, jp)
        tp, ts, tinfo = to.update(jax.tree_util.tree_map(from_numpy, grads),
                                  ts, tp)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        assert ts["step"].dtype == torch.int32
        _close(tinfo["lr"], jinfo["lr"])
        _close(tinfo["grad_norm"], jinfo["grad_norm"], rtol=1e-6)
        for tree, jtree, dt in ((tp, jp, param_dt), (ts["m"], js["m"], mv),
                                (ts["v"], js["v"], mv)):
            for name, got, want in _pairs(tree, jtree):
                assert str(got.dtype) == f"torch.{dt}", name
                g = np.asarray(to_numpy(got), np.float32)
                w = np.asarray(want, np.float32)
                tol = dict(rtol=2 ** -7, atol=0) if dt == "bfloat16" \
                    else dict(rtol=1e-6, atol=1e-6 * np.abs(w).max())
                np.testing.assert_allclose(g, w, err_msg=name, **tol)


def test_adamw_leaves_its_inputs_alone():
    p = {"a": {"w": torch.ones(3)}}
    g = {"a": {"w": torch.full((3,), 2.0)}}
    opt = topt.AdamW(topt.constant_schedule(0.1), clip_norm=1e6)
    state = opt.init(p)
    new, state2, info = opt.update(g, state, p)
    assert torch.equal(p["a"]["w"], torch.ones(3))
    assert int(state["step"]) == 0 and torch.equal(state["m"]["a"]["w"],
                                                  torch.zeros(3))
    # the first step is lr * (g/|g| + weight_decay * p): 0.1 * 1.1
    torch.testing.assert_close(new["a"]["w"], torch.full((3,), 0.89),
                               rtol=1e-6, atol=1e-6)
    assert float(info["grad_norm"]) == pytest.approx(2 * 3 ** 0.5)


def test_global_norm_of_a_nested_tree():
    tree = _nested(4)
    _close(topt.global_norm(jax.tree_util.tree_map(from_numpy, tree)),
           jopt.global_norm(jax.tree_util.tree_map(jnp.asarray, tree)))

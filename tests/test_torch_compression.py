"""The port's gradient compression (``repro_torch.optim.compression``)
against the JAX package's (``repro.optim.compression``):

* ``quantize`` bit-equal to JAX's (int8 values, scales, new errors) on
  sizes 1000, 256, 257 and 4096 x 3, with and without a carried error,
  and ``dequantize`` bit-equal too;
* ``tests/test_optim.py``'s error bound and error-feedback tests on the
  port;
* ``compressed_psum`` over 4 ``gloo`` ranks against JAX's under
  ``jax.pmap`` on 4 forced host devices, on the same numpy gradients and
  errors: the reduced values within 1e-6 relative; the new errors
  bit-equal to the JAX package's ``quantize`` of each rank's inputs,
  which is the function ``compressed_psum`` calls.  Under ``pmap`` XLA
  fuses that function (it contracts ``comp - q * scale`` into one fused
  multiply-add, and in one fusion a scale came out an ulp apart), so
  there the new errors are held within 2 ulps of their block's largest
  magnitude (they read up to 1.32);
* ``init_error`` gives float32 zeros of each leaf's shape.
"""
import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_ranks import ROOT, env, run_ranks  # noqa: E402

from repro.optim import compression as JC  # noqa: E402
from repro_torch.optim import compression as TC  # noqa: E402

SIZES = [(1000,), (256,), (257,), (4096, 3)]


def _inputs(shape, seed, err_scale):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    e = (rng.standard_normal(shape) * err_scale).astype(np.float32)
    return g, e


@pytest.mark.parametrize("err_scale", [0.0, 0.05])
@pytest.mark.parametrize("shape", SIZES, ids=str)
def test_quantize_and_dequantize_bit_equal_to_jax(shape, err_scale):
    g, e = _inputs(shape, 7, err_scale)
    jq, js, je = JC.quantize(jnp.asarray(g), jnp.asarray(e))
    tq, ts, te = TC.quantize(torch.from_numpy(g), torch.from_numpy(e))
    assert tq.dtype == torch.int8 and ts.dtype == te.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    want = JC.dequantize(jq, js, g.shape, g.size)
    got = TC.dequantize(tq, ts, g.shape, g.size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_error_bound():
    g = torch.randn(1000, generator=torch.Generator().manual_seed(0)) * 3.0
    q, scale, err = TC.quantize(g, torch.zeros_like(g))
    deq = TC.dequantize(q, scale, g.shape, g.numel())
    # per-block max / 127 quantization step bound
    step = float(scale.max())
    assert float((g - deq).abs().max()) <= step * 0.5001
    np.testing.assert_allclose(err.numpy(), (g - deq).numpy(), atol=1e-6)


def test_error_feedback_reduces_bias():
    """With error feedback, the *cumulative* compressed sum tracks the
    true cumulative sum much better than independent rounding."""
    g = torch.randn(512, generator=torch.Generator().manual_seed(1)) \
        * 1e-3 + 0.02
    err = torch.zeros_like(g)
    acc = torch.zeros_like(g)
    for _ in range(50):
        q, scale, err = TC.quantize(g, err)
        acc = acc + TC.dequantize(q, scale, g.shape, g.numel())
    true = g * 50
    assert float((acc - true).abs().max()) / float(true.abs().max()) < 0.02


def test_init_error_is_float32_zeros_of_each_leaf():
    params = {"a": torch.ones(3, 4, dtype=torch.bfloat16),
              "b": {"c": torch.ones(5)}}
    err = TC.init_error(params)
    assert err["a"].shape == (3, 4) and err["b"]["c"].shape == (5,)
    assert err["a"].dtype == err["b"]["c"].dtype == torch.float32
    assert not err["a"].any() and not err["b"]["c"].any()


# ---- compressed_psum over 4 ranks against jax.pmap --------------------------

WORLD = 4
DATA = f"""
import numpy as np
WORLD = {WORLD}
rng = np.random.default_rng(11)
SHAPES = {{"a": (1000,), "b": (257,), "c": (64, 24)}}
G = {{k: (rng.standard_normal((WORLD,) + s) * (1 + np.arange(WORLD)
      ).reshape((WORLD,) + (1,) * len(s))).astype(np.float32)
      for k, s in SHAPES.items()}}
E = {{k: (rng.standard_normal((WORLD,) + s) * 0.01).astype(np.float32)
      for k, s in SHAPES.items()}}
"""

DATA_NS = {}
exec(DATA, DATA_NS)

PORT = DATA + """
from repro_torch.optim.compression import compressed_psum


def main(rank, world):
    g = {k: torch.from_numpy(v[rank]) for k, v in G.items()}
    e = {k: torch.from_numpy(v[rank]) for k, v in E.items()}
    red, new_err = compressed_psum(g, e)
    return {k: {"red": red[k].flatten().tolist(),
                "err": new_err[k].flatten().tolist()} for k in g}
"""

JAX = DATA + """
import json
import jax, jax.numpy as jnp
from repro.optim.compression import compressed_psum
fn = jax.pmap(lambda g, e: compressed_psum(g, e, "i"), axis_name="i")
red, err = fn({k: jnp.asarray(v) for k, v in G.items()},
              {k: jnp.asarray(v) for k, v in E.items()})
print("JAX_PSUM " + json.dumps({k: {
    "red": np.asarray(red[k]).reshape(WORLD, -1).tolist(),
    "err": np.asarray(err[k]).reshape(WORLD, -1).tolist()} for k in G}))
"""


@pytest.fixture(scope="module")
def jax_psum():
    res = subprocess.run(
        [sys.executable, "-c", JAX], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env=env(XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith("JAX_PSUM ")]
    assert lines, res.stdout + res.stderr
    return json.loads(lines[-1][len("JAX_PSUM "):])


def test_compressed_psum_over_gloo_matches_jax_pmap(tmp_path, jax_psum):
    ranks = run_ranks(PORT, WORLD, tmp_path)
    for rank, got in enumerate(ranks):
        for key, want in jax_psum.items():
            red = np.array(got[key]["red"], dtype=np.float32)
            wred = np.array(want["red"][rank], dtype=np.float32)
            np.testing.assert_allclose(red, wred, rtol=1e-6, atol=0)
            # every rank holds the same sum
            np.testing.assert_array_equal(
                red, np.array(ranks[0][key]["red"], dtype=np.float32))
            err = np.array(got[key]["err"], dtype=np.float32)
            g, e = (DATA_NS[name][key][rank] for name in ("G", "E"))
            q, scale, eager = JC.quantize(jnp.asarray(g), jnp.asarray(e))
            np.testing.assert_array_equal(err, np.asarray(eager).ravel())
            # pmap's errors: XLA fuses the quantization, so they are off
            # the reference's arithmetic by up to ~1.3 ulps of the block's
            # largest magnitude
            werr = np.array(want["err"][rank], dtype=np.float64)
            bmax = np.repeat(np.asarray(scale, np.float64) * 127,
                             JC.BLOCK)[:g.size].astype(np.float32)
            assert (np.abs(err - werr) <= 2 * np.spacing(bmax)).all()

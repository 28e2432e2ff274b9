"""The port's fused residual add + RMSNorm against the JAX package's Pallas
kernel.

``repro_torch.kernels.ops.fused_add_rmsnorm`` on CPU tensors (which runs
the plain version, ``fused_add_rmsnorm_ref``) is held to
``repro.kernels.ops.fused_add_rmsnorm`` in Pallas interpret mode, on the
same numpy inputs, with the shapes, blocks and tolerances of
``tests/test_kernels.py``.  The CUDA kernel is held to its plain version
on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.interop import from_numpy, to_numpy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402


def _inputs(seed, rows, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d), dtype=np.float32).astype(dtype)
    r = rng.standard_normal((rows, d), dtype=np.float32).astype(dtype)
    s = rng.standard_normal((d,), dtype=np.float32)
    return x, r, s


def _both(x, r, s, **kw):
    want = jops.fused_add_rmsnorm(jnp.asarray(x), jnp.asarray(r),
                                  jnp.asarray(s), **kw)
    got = tops.fused_add_rmsnorm(from_numpy(x), from_numpy(r),
                                 from_numpy(s), **kw)
    return [to_numpy(t) for t in got], [np.asarray(t) for t in want]


@pytest.mark.parametrize("rows,d", [(100, 64), (256, 128), (7, 96)])
def test_fused_addnorm(rows, d):
    (y, res), (yr, resr) = _both(*_inputs(rows + d, rows, d), block_rows=64)
    np.testing.assert_allclose(y, yr, atol=1e-5)
    np.testing.assert_allclose(res, resr, atol=1e-6)


@pytest.mark.parametrize("rows,d", [(100, 64), (7, 96)])
def test_bf16_res_is_the_f32_sum_rounded(rows, d):
    """``res`` is the float32 sum rounded once to bf16, bit for bit, in
    the port and in the Pallas kernel; ``y`` comes from the unrounded sum
    and agrees within the bf16 tolerance."""
    x, r, s = _inputs(rows * d, rows, d, jnp.bfloat16)
    (y, res), (yr, resr) = _both(x, r, s, block_rows=64)
    rounded = (x.astype(np.float32) + r.astype(np.float32)).astype(
        jnp.bfloat16)
    assert res.dtype == rounded.dtype == resr.dtype
    np.testing.assert_array_equal(res.view(np.uint16),
                                  rounded.view(np.uint16))
    np.testing.assert_array_equal(res.view(np.uint16), resr.view(np.uint16))
    np.testing.assert_allclose(y.astype(np.float32), yr.astype(np.float32),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("block_rows", [1, 64, 256, 10_000])
def test_block_rows_do_not_change_the_bits(block_rows):
    x, r, s = (from_numpy(a) for a in _inputs(5, 33, 64))
    y0, res0 = tops.fused_add_rmsnorm(x, r, s)
    y, res = tops.fused_add_rmsnorm(x, r, s, block_rows=block_rows)
    assert torch.equal(y, y0) and torch.equal(res, res0)


@pytest.mark.parametrize("bad,exc", [
    (dict(block_rows=0), ValueError),
    (dict(scale=torch.ones(5)), ValueError),
    (dict(resid=torch.zeros((4, 8), dtype=torch.bfloat16)), TypeError),
])
def test_bad_arguments_raise(bad, exc):
    args = dict(x=torch.zeros((4, 8)), resid=torch.zeros((4, 8)),
                scale=torch.ones(8))
    block_rows = bad.pop("block_rows", 256)
    args.update(bad)
    with pytest.raises(exc):
        tops.fused_add_rmsnorm(args["x"], args["resid"], args["scale"],
                               block_rows=block_rows)

"""The port's GEMM entry point against the JAX package's Pallas GEMM.

``repro_torch.kernels.ops.matmul`` on CPU tensors (which runs the plain
version, ``matmul_ref``) is held to ``repro.kernels.ops.matmul`` in Pallas
interpret mode, on the same numpy inputs, with the shapes, dtypes, blocks
and tolerances of ``tests/test_kernels.py``.  The CUDA kernel
(``csrc/matmul.cu``) is held to ``matmul_ref`` on the card by
``chip_smoke.py``.  ``MatmulFn``'s gradients are held to ``jax.grad``
of the JAX oracle ``repro.kernels.ref.matmul_ref``.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
import hypothesis.strategies as st  # noqa: E402
from hypothesis import given, settings  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.gpu_model import MATMUL_TILES  # noqa: E402
from repro_torch.interop import from_numpy, to_numpy  # noqa: E402
from repro_torch.kernels import matmul as tmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels" / "csrc"


def _tol(dtype):
    return dict(atol=3e-2, rtol=3e-2) if dtype == jnp.bfloat16 \
        else dict(atol=2e-4, rtol=2e-4)


def _operands(seed, m, n, k, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k), dtype=np.float32).astype(dtype),
            rng.standard_normal((k, n), dtype=np.float32).astype(dtype))


def _both(a, b, **blocks):
    want = jops.matmul(jnp.asarray(a), jnp.asarray(b), **blocks)
    got = tops.matmul(from_numpy(a), from_numpy(b), **blocks)
    return to_numpy(got), np.asarray(want)


@pytest.mark.parametrize("m,n,k", [(64, 64, 64), (200, 90, 130),
                                   (128, 256, 512), (33, 17, 65), (1, 128, 7)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_matmul_sweep_matches_pallas(m, n, k, dtype):
    a, b = _operands(m * 1000 + n, m, n, k, dtype)
    got, want = _both(a, b, bm=64, bn=64, bk=64)
    assert got.dtype == want.dtype and got.shape == (m, n)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), **_tol(dtype))


@pytest.mark.parametrize("m,n,k", [(0, 8, 8), (8, 0, 8), (8, 8, 0),
                                   (0, 0, 0), (1, 1, 0)])
@pytest.mark.parametrize("explicit_blocks", [False, True])
def test_matmul_zero_dim(m, n, k, explicit_blocks):
    """An empty reduction axis contracts to zeros, an empty m or n gives
    the empty matrix, with or without blocks, as in the JAX package."""
    a = np.zeros((m, k), np.float32)
    b = np.zeros((k, n), np.float32)
    blocks = dict(bm=64, bn=64, bk=64) if explicit_blocks else {}
    got, want = _both(a, b, **blocks)
    assert got.shape == want.shape == (m, n)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_matmul_zero_k_contracts_to_zeros():
    out = tops.matmul(torch.zeros((5, 0)), torch.zeros((0, 7)))
    np.testing.assert_array_equal(to_numpy(out), np.zeros((5, 7)))


@settings(max_examples=15, deadline=None)
@given(m=st.integers(1, 300), n=st.integers(1, 200), k=st.integers(1, 300),
       bm=st.sampled_from([32, 64, 128]), bk=st.sampled_from([32, 128]))
def test_matmul_property(m, n, k, bm, bk):
    a, b = _operands(m + 7 * n + 13 * k, m, n, k)
    got, want = _both(a, b, bm=bm, bn=64, bk=bk)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("m,n,k", [(300, 200, 96), (64, 1000, 256)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_default_blocks_match_pallas(m, n, k, dtype):
    """Blocks 0 ask each package's tile model (the port's for the H100,
    the JAX package's for the TPU); the product is the same."""
    a, b = _operands(m + n + k, m, n, k, dtype)
    got, want = _both(a, b)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), **_tol(dtype))


@pytest.mark.parametrize("tile", [(96, 64, 64), (64, 64, 16), (256, 256, 256),
                                  (16, 16, 16)])
def test_uncompiled_tile_raises(tile):
    a, b = _operands(0, 8, 8, 8)
    with pytest.raises(ValueError, match="not compiled"):
        tops.matmul(from_numpy(a), from_numpy(b), *tile)


def test_compiled_tiles_match_the_source():
    """``MATMUL_TILES`` lists exactly the instantiations of matmul.cu."""
    src = (CSRC / "matmul.cu").read_text()
    body = src[src.index("#define MATMUL_TILES(X)"):]
    body = body[:body.index("\n\n")]
    tiles = [tuple(int(v) for v in t) for t in
             re.findall(r"X\((\d+), (\d+), (\d+)\)", body)]
    assert tiles == list(MATMUL_TILES)


@pytest.mark.parametrize("bad", [
    dict(a=(4, 3), b=(4, 5)),            # inner dimensions differ
    dict(a=(4,), b=(4, 5)),              # not a matrix
])
def test_shape_errors_raise(bad):
    with pytest.raises(ValueError, match="do not multiply"):
        tmm.matmul(torch.zeros(bad["a"]), torch.zeros(bad["b"]), 64, 64, 64)


def test_mixed_types_raise():
    with pytest.raises(TypeError, match="one type"):
        tops.matmul(torch.zeros((4, 4)), torch.zeros((4, 4),
                                                     dtype=torch.bfloat16))


@pytest.mark.parametrize("m,n,k", [(64, 64, 64), (200, 90, 130), (33, 17, 65)])
def test_matmulfn_matches_jax_grad(m, n, k):
    """``MatmulFn``'s forward and both operand gradients (two more GEMMs
    through ``ops.matmul``: dC @ B^T and A^T @ dC) against ``jax.grad``
    of ``matmul_ref``, float32, with the float32 tolerance."""
    a, b = _operands(m + n + k, m, n, k)
    dc = np.random.default_rng(7).standard_normal((m, n), dtype=np.float32)

    def loss(a, b):
        return jnp.sum(jref.matmul_ref(a, b) * dc)
    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    at, bt = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    c = tmm.MatmulFn.apply(at, bt)
    np.testing.assert_allclose(c.detach().numpy(),
                               np.asarray(jref.matmul_ref(a, b)),
                               **_tol(jnp.float32))
    (c * torch.from_numpy(dc)).sum().backward()
    for t, w in zip((at, bt), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   **_tol(jnp.float32))


def test_matmulfn_makes_only_the_needed_gradients():
    """The backward calls ``impl.matmul`` once for each operand that
    needs a gradient, on contiguous operands."""
    shapes = []

    class Recording:
        def matmul(self, a, b):
            assert a.is_contiguous() and b.is_contiguous()
            shapes.append((tuple(a.shape), tuple(b.shape)))
            return tops.matmul(a, b)
    a = torch.randn(5, 3)
    b = torch.randn(3, 4, requires_grad=True)
    tmm.MatmulFn.apply(a, b, Recording()).sum().backward()
    assert shapes == [((5, 3), (3, 4)), ((3, 5), (5, 4))]
    shapes.clear()
    a.requires_grad_()
    tmm.MatmulFn.apply(a, b, Recording()).t().sum().backward()
    assert shapes == [((5, 3), (3, 4)), ((5, 4), (4, 3)), ((3, 5), (5, 4))]

"""The port's batch-norm forward against the JAX package's Pallas kernel.

``repro_torch.kernels.ops.bn_forward`` on CPU tensors (which runs the
plain version, ``bn_forward_ref``: the oracle's two-pass variance) is
held to ``repro.kernels.ops.bn_forward`` in Pallas interpret mode (one-
pass variance ``E[x^2] - mu^2``), on the same numpy inputs, with the
shapes, blocks and tolerances of ``tests/test_kernels.py``.  The CUDA
kernel, which keeps the one-pass formula, is held to ``bn_forward_ref``
on the card by ``chip_smoke.py``.  The backward oracle the next slice
uses, ``bn_backward_ref``, is held to the JAX oracle and to autograd.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.interop import from_numpy, to_numpy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


def _inputs(seed, n, c, shift=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c), dtype=np.float32) + np.float32(shift)
    g = rng.standard_normal((c,), dtype=np.float32)
    b = rng.standard_normal((c,), dtype=np.float32)
    return x, g, b


def _port(x, g, b, **kw):
    return [to_numpy(t) for t in tops.bn_forward(
        from_numpy(x), from_numpy(g), from_numpy(b), **kw)]


@pytest.mark.parametrize("n,c", [(300, 70), (256, 128), (64, 33)])
def test_bn_forward(n, c):
    x, g, b = _inputs(n + c, n, c)
    want = jops.bn_forward(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                           block_rows=64, block_c=32)
    y, mu, psi = _port(x, g, b, block_rows=64, block_c=32)
    yr, mur, psir = (np.asarray(t) for t in want)
    np.testing.assert_allclose(y, yr, atol=1e-4)
    np.testing.assert_allclose(mu, mur, atol=1e-5)
    np.testing.assert_allclose(psi, psir, atol=1e-4)


def test_shifted_mean():
    """Channels with mean 10.  The port's plain version (two-pass
    variance) against the Pallas kernel (``E[x^2] - mu^2``): at this
    shift the two formulas put psi about 2e-5 apart (1.6e-5 to 1.7e-5
    on these inputs), inside the psi tolerance 1e-4 and mu's 1e-5.  y
    carries psi's difference times |x - mu| * |gamma| (up to about 15
    here), so its tolerance is 5e-4 rather than 1e-4.  Against the JAX
    oracle, which also takes two passes, the tolerances stay those of
    ``tests/test_kernels.py``."""
    x, g, b = _inputs(2, 4096, 64, shift=10.0)
    y, mu, psi = _port(x, g, b)
    pallas = [np.asarray(t) for t in jops.bn_forward(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))]
    np.testing.assert_allclose(y, pallas[0], atol=5e-4)
    np.testing.assert_allclose(mu, pallas[1], atol=1e-5)
    np.testing.assert_allclose(psi, pallas[2], atol=1e-4)
    oracle = [np.asarray(t) for t in jref.bn_forward_ref(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))]
    np.testing.assert_allclose(y, oracle[0], atol=1e-4)
    np.testing.assert_allclose(mu, oracle[1], atol=1e-5)
    np.testing.assert_allclose(psi, oracle[2], atol=1e-4)


@pytest.mark.parametrize("n,c", [(300, 70), (64, 33)])
def test_bn_backward_ref_matches_jax_oracle(n, c):
    x, g, b = _inputs(n * c, n, c)
    dy = np.random.default_rng(1).standard_normal((n, c), dtype=np.float32)
    _, mu, psi = jref.bn_forward_ref(jnp.asarray(x), jnp.asarray(g),
                                     jnp.asarray(b))
    want = jref.bn_backward_ref(jnp.asarray(x), jnp.asarray(dy),
                                jnp.asarray(g), mu, psi)
    got = tref.bn_backward_ref(from_numpy(x), from_numpy(dy), from_numpy(g),
                               from_numpy(np.asarray(mu)),
                               from_numpy(np.asarray(psi)))
    for a, w in zip(got, want):
        np.testing.assert_allclose(to_numpy(a), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


def test_bn_backward_ref_matches_autograd():
    """Eq. 28 equals autograd of the plain forward (the torch form of
    ``test_bn_backward_matches_autodiff``)."""
    x, g, b = (torch.from_numpy(a) for a in _inputs(3, 128, 16))
    g = (g + 1.0).requires_grad_()
    x.requires_grad_()
    b.requires_grad_()
    dy = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (128, 16), dtype=np.float32))
    y, mu, psi = tref.bn_forward_ref(x, g, b)
    dx_ad, dg_ad, db_ad = torch.autograd.grad((y * dy).sum(), (x, g, b))
    dx, dg, db = tref.bn_backward_ref(x.detach(), dy, g.detach(),
                                      mu.detach(), psi.detach())
    for got, want in ((dx, dx_ad), (dg, dg_ad), (db, db_ad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3,
                                   rtol=1e-3)


@pytest.mark.parametrize("kw,match", [
    (dict(block_c=2048), "exceeds"),
    (dict(block_rows=0), "positive int"),
    (dict(n=0), "nothing to normalise"),
    (dict(c_gamma=5), "do not match"),
])
def test_bad_arguments_raise(kw, match):
    kw = dict(kw)
    n, c_gamma = kw.pop("n", 8), kw.pop("c_gamma", 4)
    with pytest.raises(ValueError, match=match):
        tops.bn_forward(torch.zeros((n, 4)), torch.ones(c_gamma),
                        torch.zeros(c_gamma), **kw)

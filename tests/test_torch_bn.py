"""The port's batch-norm forward against the JAX package's Pallas kernel.

``repro_torch.kernels.ops.bn_forward`` on CPU tensors (which runs the
plain version, ``bn_forward_ref``: the oracle's two-pass variance) is
held to ``repro.kernels.ops.bn_forward`` in Pallas interpret mode (one-
pass variance ``E[x^2] - mu^2``), on the same numpy inputs, with the
shapes, blocks and tolerances of ``tests/test_kernels.py``.  The CUDA
kernel computes shifted sums merged by Chan's formula; a float32 model
of that arithmetic, at ``bn_layout``'s block boundaries and in the
kernel's merge order, is held here to the JAX oracle, and the kernel to
``bn_forward_ref`` on the card by ``chip_smoke.py``.  The backward oracle,
``bn_backward_ref``, is held to the JAX oracle and to autograd; the
backward entry point ``ops.bn_backward`` to ``repro.kernels.ops.
bn_backward`` (Pallas, interpret mode), and ``BatchNormFn``'s gradients
to ``jax.grad`` of the JAX oracle.  The CUDA backward kernel is held to
``bn_backward_ref`` on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.gpu_model import bn_layout  # noqa: E402
from repro_torch.interop import from_numpy, to_numpy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.bn import BatchNormFn  # noqa: E402


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


def _backward_inputs(seed, n, c, dtype):
    """x, dy in ``dtype`` and gamma, with the JAX forward's mu and psi
    of that x, as numpy arrays."""
    x, g, b = _inputs(seed, n, c)
    dy = np.random.default_rng(seed + 1).standard_normal((n, c),
                                                         dtype=np.float32)
    xj, dyj = jnp.asarray(x, dtype), jnp.asarray(dy, dtype)
    _, mu, psi = jops.bn_forward(xj, jnp.asarray(g), jnp.asarray(b),
                                 block_rows=64, block_c=32)
    return [np.asarray(a) for a in (xj, dyj, g, mu, psi)]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("n,c", [(300, 70), (256, 128), (64, 33)])
def test_bn_backward(n, c, dtype):
    """``ops.bn_backward`` on CPU tensors (``bn_backward_ref``) against
    the Pallas Algorithm 1 in interpret mode, with the shapes, tiles and
    tolerances of ``tests/test_kernels.py`` (dx 1e-4, dgamma and dbeta
    1e-3 in float32; 3e-2 in bfloat16).  In bfloat16 the Pallas kernel
    stores x^ rounded to bfloat16 between its parts and the plain
    version keeps it unrounded, inside the bfloat16 tolerance."""
    arrs = _backward_inputs(n * c, n, c, dtype)
    want = jops.bn_backward(*(jnp.asarray(a) for a in arrs), block_rows=64,
                            block_c=32)
    got = tops.bn_backward(*(from_numpy(a) for a in arrs), block_rows=64,
                           block_c=32)
    assert got[0].dtype == from_numpy(arrs[0]).dtype
    assert got[1].dtype == got[2].dtype == torch.float32
    bf16 = dtype == jnp.bfloat16
    for i, (a, w) in enumerate(zip(got, want)):
        tol = 3e-2 if bf16 else (1e-4 if i == 0 else 1e-3)
        np.testing.assert_allclose(to_numpy(a).astype(np.float32),
                                   np.asarray(w, np.float32), atol=tol,
                                   rtol=tol)


def test_batchnormfn_matches_jax_grad():
    """``BatchNormFn``'s gradients equal ``jax.grad`` of the JAX oracle's
    forward (the autodiff case of ``tests/test_kernels.py``)."""
    x, g, b = _inputs(3, 128, 16)
    g = g + np.float32(1.0)
    dy = np.random.default_rng(4).standard_normal((128, 16),
                                                  dtype=np.float32)

    def fwd(x, g, b):
        return jnp.sum(jref.bn_forward_ref(x, g, b)[0] * dy)
    want = jax.grad(fwd, argnums=(0, 1, 2))(*map(jnp.asarray, (x, g, b)))
    xt, gt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    y = BatchNormFn.apply(xt, gt, bt)
    np.testing.assert_allclose(
        y.detach().numpy(),
        np.asarray(jref.bn_forward_ref(*map(jnp.asarray, (x, g, b)))[0]),
        atol=1e-4)
    (y * torch.from_numpy(dy)).sum().backward()
    for t, w in zip((xt, gt, bt), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=1e-3, rtol=1e-3)


def test_batchnormfn_uses_the_given_impl():
    """The forward and the backward go through ``impl``, and the
    parameters' gradients come back in their own types."""
    calls = []

    class Recording:
        def bn_forward(self, *a):
            calls.append("bn_forward")
            return tops.bn_forward(*a)

        def bn_backward(self, *a):
            calls.append("bn_backward")
            assert a[1].is_contiguous()
            return tops.bn_backward(*a)
    x = torch.randn(40, 6, requires_grad=True)
    g = torch.ones(6, dtype=torch.bfloat16, requires_grad=True)
    b = torch.zeros(6, dtype=torch.bfloat16, requires_grad=True)
    y = BatchNormFn.apply(x, g, b, Recording())
    (y.t() * torch.randn(6, 40)).sum().backward()   # a non-contiguous dy
    assert calls == ["bn_forward", "bn_backward"]
    assert g.grad.dtype == b.grad.dtype == torch.bfloat16
    assert x.grad.shape == x.shape


@pytest.mark.parametrize("kw,err,match", [
    (dict(mu_dtype=torch.bfloat16), TypeError, "float32"),
    (dict(dy_rows=7), ValueError, "do not match"),
    (dict(block_c=2048), ValueError, "exceeds"),
    (dict(block_rows=0), ValueError, "positive int"),
    (dict(n=0), ValueError, "nothing to differentiate"),
    (dict(dy_dtype=torch.bfloat16), TypeError, "one type"),
])
def test_bn_backward_bad_arguments_raise(kw, err, match):
    kw = dict(kw)
    n = kw.pop("n", 8)
    mu = torch.zeros(4, dtype=kw.pop("mu_dtype", torch.float32))
    dy = torch.zeros((kw.pop("dy_rows", n), 4),
                     dtype=kw.pop("dy_dtype", torch.float32))
    with pytest.raises(err, match=match):
        tops.bn_backward(torch.zeros((n, 4)), dy, torch.ones(4), mu,
                         torch.ones(4), **kw)


# ---- the CUDA forward's statistics, modelled in float32 ------------------

def _merge(a, b):
    """Chan's merge of (count, shift K, mean offset s, M2) per channel,
    offsets against a's shift, as ``bn_forward.cu::merge``; a count of 0
    is the identity."""
    na, ka, sa, ma = a
    nb, kb, sb, mb = b
    if nb == 0:
        return a
    if na == 0:
        return b
    n = na + nb
    d = ((kb - ka) + sb) - sa
    w = torch.tensor(nb / n, dtype=torch.float32)
    return (n, ka, sa + d * w, ma + mb + d * d * (na * w))


def shifted_stats(x, eps=1e-5):
    """``(y, mu, psi)`` of float32 ``x`` as the CUDA forward computes
    them: per row group of ``bn_layout`` the channel's value in its first
    row as shift K, float32 sums of (x - K) and (x - K)^2, (K, s, M2);
    the groups merged by lane l of a warp taking groups l, l + 32, ...,
    then a tree over the 32 lanes; y from the unrounded K + s."""
    n, c = x.shape
    lay = bn_layout(n, c, 4, 1)
    parts = []
    for r0, r1 in lay.row_bounds(n):
        k = x[r0]
        d = x[r0:r1] - k
        s1, s2 = d.sum(0), (d * d).sum(0)
        s = s1 / (r1 - r0)
        parts.append((r1 - r0, k, s, torch.clamp(s2 - s1 * s, min=0.0)))
    empty = (0, None, None, None)
    lanes = [empty] * 32
    for i, p in enumerate(parts):
        lanes[i % 32] = _merge(lanes[i % 32], p)
    off = 16
    while off:
        lanes = [_merge(lanes[i], lanes[i + off]) if i < off else lanes[i]
                 for i in range(32)]
        off //= 2
    cnt, k, s, m2 = lanes[0]
    psi = torch.rsqrt(m2 / cnt + eps)
    return k, s, psi


def _model_forward(x, g, b):
    xt, gt, bt = (torch.from_numpy(a) for a in (x, g, b))
    k, s, psi = shifted_stats(xt)
    y = ((xt - k) - s) * (psi * gt) + bt
    return [a.numpy() for a in (y, k + s, psi)]


def _one_pass(x, g, b, eps=1e-5):
    """The Pallas kernel's ``var = E[x^2] - mu^2`` in float32."""
    xt, gt, bt = (torch.from_numpy(a) for a in (x, g, b))
    mu = xt.mean(0)
    psi = torch.rsqrt((xt * xt).mean(0) - mu * mu + eps)
    return [a.numpy() for a in ((xt - mu) * psi * gt + bt, mu, psi)]


def _assert_bn_close(got, want):
    """``tests/test_kernels.py``'s forward tolerances."""
    for a, w, atol in zip(got, want, (1e-4, 1e-5, 1e-4)):
        np.testing.assert_allclose(a, np.asarray(w, np.float32), atol=atol)


def _exact(x, g, b, eps=1e-5):
    """The oracle's two-pass formula in float64 numpy (the JAX oracle
    casts x to float32 whatever it is given)."""
    xd = x.astype(np.float64)
    mu = xd.mean(0)
    psi = 1.0 / np.sqrt(xd.var(0) + eps)
    return [(xd - mu) * psi * g + b, mu, psi]


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("shift", [10.0, 100.0, 1000.0])
@pytest.mark.parametrize("n,c", [(4096, 64), (300, 70), (64, 33)])
def test_shifted_stats_match_the_oracle(n, c, shift, seed):
    """The kernel's statistics at means shifted by 10, 100 and 1000,
    within the tolerances of ``tests/test_kernels.py``: against the JAX
    oracle at shifts 10 and 100, and against the oracle's formula in
    float64 at all three.  The JAX oracle, which computes in float32, is
    no yardstick at shift 1000: on (4096, 64) its mean lies 1.3e-4 from
    the float64 one (two ulps of 1000) and its y 1.8e-4, outside its own
    mu and y tolerances."""
    x, g, b = _inputs(seed, n, c, shift)
    got = _model_forward(x, g, b)
    _assert_bn_close(got, _exact(x, g, b))
    if shift < 1000.0:
        _assert_bn_close(got, [np.asarray(t) for t in jref.bn_forward_ref(
            jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))])


def test_one_pass_variance_fails_at_shift_1000():
    """The finding the shifted sums close: at shift 1000 the Pallas
    kernel's E[x^2] - mu^2 (modelled in float32) puts y far outside its
    tolerance, where the shifted sums stay within it."""
    x, g, b = _inputs(0, 4096, 64, 1000.0)
    exact = _exact(x, g, b)
    assert np.abs(_one_pass(x, g, b)[0] - exact[0]).max() > 0.1
    assert np.abs(_model_forward(x, g, b)[0] - exact[0]).max() < 1e-4


def test_cpu_calls_leave_the_route_counters_alone():
    """On the CPU the wrappers run the plain versions: no launch, no
    route."""
    from repro_torch.kernels import bn
    before = (bn.bn_forward.launches, dict(bn.bn_forward.routes),
              bn.bn_backward.launches, dict(bn.bn_backward.routes))
    x, g, b = (torch.from_numpy(a) for a in _inputs(1, 64, 8))
    _, mu, psi = tops.bn_forward(x, g, b)
    tops.bn_backward(x, x, g, mu, psi)
    assert (bn.bn_forward.launches, bn.bn_forward.routes,
            bn.bn_backward.launches, bn.bn_backward.routes) == before

"""The port's training step (``repro_torch.kernels.training``) against the
same network composed in JAX.

The network is a reduced layer list built with each package's own
``core.networks`` helpers: a 3x3 convolution at 8x8, BN and ReLU, a 3x3
max pool of stride 2, one ``_bottleneck`` of stride 2 with its ``.down``
branch, global average pooling and an FC layer to 10 classes, at batch 2.
``init_params`` makes the weights with numpy and both sides get the same
arrays.  The JAX side composes ``lax.conv_general_dilated`` (NHWC/HWIO),
``repro.kernels.ref.bn_forward_ref``, ``jax.grad`` and the JAX package's
``SGDM``; the port runs ``kernels.ops`` on CPU tensors, whose wrappers run
their plain versions.  Loss, every gradient and the parameters after two
steps agree within 1e-4 in float32.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import backward as jbackward  # noqa: E402
from repro.core import layers as jL  # noqa: E402
from repro.core import networks as jN  # noqa: E402
from repro.core.layers import ConvLayer as JConvLayer  # noqa: E402
from repro.core.layers import SimdLayer as JSimdLayer  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.core import layers as tL  # noqa: E402
from repro_torch.core import networks as tN  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import training as T  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BATCH, CLASSES = 2, 10
TOL = dict(atol=1e-4, rtol=1e-4)
# the padding of each layer, as ``networks._conv`` and the ResNet stem's
# pool are written (``ConvLayer`` does not store it)
PAD = {"stem.conv": 1, "s0.b0.c2": 1, "stem.maxpool": 1}


def small_net(N, L):
    """The reduced network from one package's helpers."""
    net = [N._conv("stem.conv", BATCH, 3, 8, 8, 3, 1, 1, has_bias=False)]
    N._bn_relu(net, "stem", BATCH, 8, 8)
    net.append(L.pool("stem.maxpool", 4, 4, BATCH, 8, r=3, s=2))
    h = N._bottleneck(net, "s0.b0", BATCH, 4, 8, 4, 2)
    net.append(L.global_avg_pool("gap", h, h, BATCH, 16))
    net.append(L.fc("fc", BATCH, 16, CLASSES))
    return net


def _branch(name):
    parts = name.split(".")
    if len(parts) >= 3:
        return ".".join(parts[:2]), parts[2]
    return None, None


def jax_logits(params, images, layers):
    """The network composed in JAX, NHWC activations."""
    x = images
    block_in, main, down = {}, {}, {}
    for layer in layers:
        blk, branch = _branch(layer.name)
        if layer.name == f"{blk}.c1":
            block_in[blk] = x
        inp = block_in[blk] if layer.name == f"{blk}.down" else x
        if isinstance(layer, JConvLayer):
            p = PAD.get(layer.name, 0)
            x = jax.lax.conv_general_dilated(
                inp, params[f"{layer.name}.w"], (layer.s, layer.s),
                [(p, p), (p, p)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
                precision=jax.lax.Precision.HIGHEST)
            if layer.has_bias:
                x = x + params[f"{layer.name}.b"]
        elif layer.op == "bn":
            rows = x.reshape(-1, x.shape[-1])
            y, _, _ = jref.bn_forward_ref(rows, params[f"{layer.name}.gamma"],
                                          params[f"{layer.name}.beta"])
            x = y.reshape(x.shape)
        elif layer.op == "relu":
            x = jnp.maximum(x, 0.0)
        elif layer.op == "pool_max":
            p, r, s = PAD[layer.name], layer.pool_r, layer.pool_s
            x = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, r, r, 1),
                                      (1, s, s, 1),
                                      [(0, 0), (p, p), (p, p), (0, 0)])
        elif layer.op == "gap":
            x = x.mean(axis=(1, 2), keepdims=True)
        elif layer.op == "tensor_add":
            x = main[blk] + down.get(blk, block_in[blk])
        if branch == "down":
            down[blk] = x
        elif branch in ("c1", "c2", "c3"):
            main[blk] = x
    return x.reshape(x.shape[0], -1)


def jax_loss(params, images, labels, layers):
    logits = jax_logits(params, images, layers)
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(logp[jnp.arange(labels.shape[0]), labels])


def _data(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BATCH, 8, 8, 3), dtype=np.float32),
            rng.integers(0, CLASSES, BATCH))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("zero_gamma", [False, True])
@pytest.mark.parametrize("impl", ["ops", "plain"])
def test_two_steps_match_jax(impl, zero_gamma):
    """Loss and every gradient at each of two SGDM steps, and every
    parameter after them, against the JAX composition (float32)."""
    tlayers, jlayers = small_net(tN, tL), small_net(jN, jL)
    arrs = T.init_params(tlayers, seed=7, zero_gamma=zero_gamma)
    images, labels = _data(3)
    net = T.Network(tlayers, T.params_from_numpy(arrs, "cpu"),
                    impl=tops if impl == "ops" else T.PLAIN,
                    gemm_dtype=torch.float32)
    opt = T.make_optimizer(net)
    jparams = {k: jnp.asarray(v) for k, v in arrs.items()}
    sgdm = jopt.SGDM(jopt.constant_schedule(T.LR), momentum=T.MOMENTUM)
    jstate = sgdm.init(jparams)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, x, y: jax_loss(p, x, y, jlayers)))
    for _ in range(2):
        jl, jg = grad_fn(jparams, jnp.asarray(images), jnp.asarray(labels))
        jparams, jstate, _ = sgdm.update(jg, jstate, jparams)
        loss = T.train_step(net, opt, torch.from_numpy(images),
                            torch.from_numpy(labels))
        _close(loss.numpy(), jl)
        for k, p in net.params().items():
            _close(p.grad.numpy(), jg[k])
    for k, p in net.params().items():
        _close(p.detach().numpy(), jparams[k])


def test_step_calls_each_kernel_as_counted():
    """A recording ``impl`` sees, in one step, as many calls of each
    kernel as ``training_launches`` counts on the same layer list, which
    equals the count on the JAX package's ``expand_training_graph``."""
    tlayers, jlayers = small_net(tN, tL), small_net(jN, jL)
    calls = {"matmul": 0, "bn_forward": 0, "bn_backward": 0}

    class Recording:
        def __getattr__(self, name):
            def call(*args):
                calls[name] += 1
                return getattr(tops, name)(*args)
            return call
    net = T.Network(tlayers, T.params_from_numpy(T.init_params(tlayers, 1), "cpu"),
                    impl=Recording(), gemm_dtype=torch.float32)
    images, labels = _data(4)
    T.train_step(net, T.make_optimizer(net), torch.from_numpy(images),
                 torch.from_numpy(labels))
    graph = jbackward.expand_training_graph(jlayers)
    want = {"matmul": sum(isinstance(l, JConvLayer) for l in graph),
            "bn_forward": sum(isinstance(l, JSimdLayer) and l.op == "bn"
                              for l in graph),
            "bn_backward": sum(isinstance(l, JSimdLayer)
                               and l.op == "bn_back" for l in graph)}
    assert calls == want == T.training_launches(tlayers)
    assert want == {"matmul": 3 * 6 - 1, "bn_forward": 5, "bn_backward": 5}


@pytest.mark.parametrize("net", ["resnet50", "resnet18"])
def test_training_launches_of_the_registry(net):
    """ResNet-50 at batch 32: 54 + 53 + 54 GEMMs, 53 BN forwards and
    backwards; the same counts on the JAX package's operation list."""
    tlayers = tN.NETWORKS[net](32)
    graph = jbackward.expand_training_graph(jN.NETWORKS[net](32))
    n_conv = sum(isinstance(l, JConvLayer) for l in jN.NETWORKS[net](32))
    got = T.training_launches(tlayers)
    assert got["matmul"] == sum(isinstance(l, JConvLayer) for l in graph) \
        == 3 * n_conv - 1
    assert got["bn_forward"] == got["bn_backward"] == sum(
        isinstance(l, JSimdLayer) and l.op == "bn_back" for l in graph)
    if net == "resnet50":
        assert got == {"matmul": 161, "bn_forward": 53, "bn_backward": 53}


@pytest.mark.parametrize("net", ["resnet50", "resnet18"])
def test_padding_is_derived_as_the_builders_pad(net):
    """``networks._conv`` pads every ResNet convolution by (k - 1) // 2
    and the stem's max pool by 1; the derived padding agrees."""
    h = 224
    for layer in tN.NETWORKS[net](2):
        if isinstance(layer, tL.ConvLayer):
            assert T.conv_padding(layer) == ((layer.kh - 1) // 2,) * 2
            h = layer.oh
        elif layer.op == "pool_max":
            assert T.pool_padding(layer, h) == 1


@pytest.mark.parametrize("k,s,pad", [(3, 1, 1), (3, 2, 1), (7, 2, 3),
                                     (1, 2, 0), (1, 1, 0)])
def test_im2col_gemm_is_a_convolution(k, s, pad):
    """im2col times the HWIO weight flattened to (k*k*ic, oc) is the
    convolution, in float64 against ``torch.nn.functional.conv2d``."""
    gen = torch.Generator().manual_seed(k * 10 + s)
    x = torch.randn(2, 9, 9, 5, generator=gen, dtype=torch.float64)
    w = torch.randn(k, k, 5, 4, generator=gen, dtype=torch.float64)
    got = T.im2col(x, k, k, s, pad, pad) @ w.reshape(-1, 4)
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2),
                                      w.permute(3, 2, 0, 1), stride=s,
                                      padding=pad).permute(0, 2, 3, 1)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want.reshape(-1, 4).numpy(),
                               rtol=1e-12, atol=1e-12)


def test_bad_padding_raises():
    layer = tL.ConvLayer("c", 1, 3, 8, 8, 4, 5, 5, 3, 3, s=1)
    with pytest.raises(ValueError, match="no symmetric padding"):
        T.conv_padding(layer)


def test_init_params_zero_gamma():
    """Goyal et al.'s init: the last BN of each residual block starts
    with gamma 0; every other parameter is as without it."""
    layers = small_net(tN, tL)
    a = T.init_params(layers, 5)
    b = T.init_params(layers, 5, zero_gamma=True)
    for k in a:
        if k.endswith(".c3.bn.gamma"):
            assert not b[k].any()
        else:
            np.testing.assert_array_equal(a[k], b[k])


def test_pinned_decisions_reproduce_the_step():
    """A step pinned to the choices recorded in the same step gives the
    same loss and gradients, bit for bit; pinned to another run's
    choices, a ReLU multiplies by that run's mask and the pool gathers
    that run's elements."""
    layers = small_net(tN, tL)
    arrs = T.init_params(layers, 9)
    images, labels = (torch.from_numpy(a) for a in _data(5))
    nets = [T.Network(layers, T.params_from_numpy(arrs, "cpu"),
                      gemm_dtype=torch.float32) for _ in range(2)]
    decisions = {}
    loss, grads = T.loss_and_grads(nets[0], images, labels, decisions)
    assert set(decisions) == {"stem.relu", "stem.maxpool", "s0.b0.c1.relu",
                              "s0.b0.c2.relu", "s0.b0.out_relu"}
    assert decisions["stem.maxpool"].shape == (BATCH, 8, 4, 4)
    pinned_loss, pinned = T.loss_and_grads(nets[1], images, labels,
                                           decisions, pin=True)
    assert torch.equal(loss, pinned_loss)
    for k in grads:
        assert torch.equal(grads[k], pinned[k]), k
    x = torch.randn(2, 5, 5, 3)
    pool = T.MaxPool(3, 2, 1)
    rec = {}
    want = pool(x, "p", rec)
    assert torch.equal(pool(x + 0.0, "p", rec, pin=True), want)
    relu = T.ReLU()
    mask = {"r": torch.rand(2, 5, 5, 3) > 0.5}
    assert torch.equal(relu(x, "r", mask, pin=True), x * mask["r"])


def _load(path):
    """A script of the repository as a module (its ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_perturbed_plain_and_relative_errors():
    """With no noise the perturbed plain versions of the chip check's
    float32 control (``chip_smoke.noisy_plain``, also the conditioning
    script's) are the plain versions; with noise a GEMM moves by about
    ``rel``; ``relative_errors`` is |got - want| / |want|, or
    |got - want| where ``want`` is 0."""
    smoke = _load(ROOT / "chip_smoke.py")
    gen = torch.Generator().manual_seed(0)
    a, b = torch.randn(64, 32, generator=gen), torch.randn(32, 16,
                                                           generator=gen)
    want = T.PLAIN.matmul(a, b)
    same = smoke.noisy_plain(0.0, torch.Generator().manual_seed(1))
    assert torch.equal(same.matmul(a, b), want)
    assert same.bn_backward is T.PLAIN.bn_backward
    noisy = smoke.noisy_plain(1e-3, torch.Generator().manual_seed(1))
    err = T.relative_errors({"c": noisy.matmul(a, b)}, {"c": want})["c"]
    assert 5e-4 < err < 2e-3
    errs = T.relative_errors({"x": torch.ones(4), "z": torch.ones(4)},
                             {"x": torch.full((4,), 2.0),
                              "z": torch.zeros(4)})
    assert errs == {"x": 0.5, "z": 2.0}


def test_params_from_numpy_takes_its_device():
    """No default device: the caller says where the step runs."""
    with pytest.raises(TypeError):
        T.params_from_numpy({"w": np.ones(2, np.float32)})


@pytest.mark.parametrize("bits", [7, 5, 3])
def test_round_mantissa(bits):
    """``chip_smoke.round_mantissa`` rounds to nearest, ties to even, as
    numpy does on the scaled mantissa; at 7 bits it keeps bfloat16."""
    smoke = _load(ROOT / "chip_smoke.py")
    x = torch.randn(4096, generator=torch.Generator().manual_seed(bits)) \
        * 10.0 ** torch.randint(-3, 4, (4096,))
    m, e = np.frexp(x.numpy().astype(np.float64))
    want = np.ldexp(np.round(m * 2.0 ** (bits + 1)), e - bits - 1)
    ties = torch.tensor([1 + 2.0 ** -(bits + 1), 1 + 3 * 2.0 ** -(bits + 1),
                         -(1 + 2.0 ** -(bits + 1))])
    assert np.array_equal(smoke.round_mantissa(x, bits).numpy(),
                          want.astype(np.float32))
    assert smoke.round_mantissa(ties, bits).tolist() == [
        1.0, 1 + 2.0 ** -(bits - 1), -1.0]
    bf = x.to(torch.bfloat16)
    assert torch.equal(smoke.round_mantissa(bf, 7), bf)


def test_rounded_plain_control():
    """The chip check's bf16 control: at 7 bits the rounded plain versions
    are the plain versions in bfloat16, at 5 they move a GEMM by about
    2**-6."""
    smoke = _load(ROOT / "chip_smoke.py")
    gen = torch.Generator().manual_seed(3)
    a = torch.randn(64, 48, generator=gen).to(torch.bfloat16)
    b = torch.randn(48, 32, generator=gen).to(torch.bfloat16)
    want = T.PLAIN.matmul(a, b)
    assert torch.equal(smoke.rounded_plain(7).matmul(a, b), want)
    assert smoke.rounded_plain(5).bn_forward is T.PLAIN.bn_forward
    err = T.relative_errors({"c": smoke.rounded_plain(5).matmul(a, b)},
                            {"c": want})["c"]
    assert 2.0 ** -9 < err < 2.0 ** -5

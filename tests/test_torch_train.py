"""The port's training path (``Model.loss``, ``launch/train.py``) against
the JAX package's, and the kernel routing of a training step.

* ``Model.loss`` of all ten configurations at ``reduced`` size in
  float32, from the same numpy weights and tokens (carried by
  ``interop.params_from_numpy``): loss, ce and the MoE aux loss within
  1e-6 relative, and every leaf's gradient (``torch.autograd.grad`` against ``jax.grad``)
  within 1e-4 relative Frobenius -- 5e-4 for pixtral and 2e-3 for
  whisper, the two models ``tests/test_torch_decode.py`` finds badly
  conditioned at this init (their logits sit near float32's floor at
  2e-4); 3e-4 for recurrentgemma and 5e-3 for llama4, whose worst leaf
  in the JAX model itself moves by 1.6-2.3e-4 and 6.2e-4-4.3e-3 when
  its weights move by 1e-7 relative noise (three draws each of
  ``tests/jax_noise_floor.py``; the port reads 1.2e-4 and 1.3e-3) --
  with ``ce_chunk`` 0 and 16 (a chunked, padded loss).
* Two ``make_train_step`` steps (AdamW, cosine schedule) against the JAX
  step: lr exact to float32, loss within 1e-6, ``grad_norm`` within 2e-4
  relative, parameters and both moments within 1e-3 relative Frobenius.
  Adam's first steps move an element by about the learning rate
  whatever the size of its gradient, so an element whose gradient is
  within float32's reordering error of zero moves differently in the
  two packages; that is what the 1e-3 covers (smollm reads 1.7e-4).
* ``train_loop("smollm-360m", device="cpu")`` lowers the loss as
  ``tests/test_system.py::test_training_reduces_loss`` holds the JAX
  loop; without ``device`` it needs CUDA and raises here.
* Opaque kernels: an ``impl`` whose functions return the plain result
  computed under ``torch.no_grad()`` and detached, as the card's ctypes
  kernels do.  Through ``ops.differentiable`` the gradients equal the
  plain route's (autograd through the plain versions; 1e-6 relative,
  the GEMM backward's transposed copies reorder nothing but BLAS may);
  called directly they are missing.  A counting ``impl`` sees ``3 (7n +
  1)`` GEMMs (forward, dX, dW), ``2n + 1`` add+norms and ``n``
  attentions in a step; with Mamba2, RG-LRU and MoE layers, three times
  a prefill's GEMMs (``test_torch_decode.kernel_calls``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_decode import (ARCHS, inputs, jx, kernel_calls,  # noqa: E402
                               numpy_params, tx)

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import forward as F  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

GRAD_REL = {"pixtral-12b": 5e-4, "whisper-tiny": 2e-3,
            "recurrentgemma-9b": 3e-4, "llama4-maverick-400b-a17b": 5e-3}
F32 = torch.float32


def configs(arch, **kw):
    """The reduced float32 configuration in both packages; the port's
    keeps ``remat`` at its default (True, ``full``), whose values are
    those without it (``tests/test_torch_remat.py``)."""
    jcfg = jreduced(jget_config(arch)).replace(dtype=jnp.float32,
                                               remat=False, **kw)
    tcfg = reduced(get_config(arch)).replace(dtype=F32, **kw)
    return jcfg, tcfg


def paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def rel(got, want) -> float:
    g = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                   np.float64)
    w = np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def grads_of(model, params, batch):
    """``(loss, metrics, grads)`` of ``model.loss`` at ``params``."""
    loss, metrics = model.loss(params, batch)
    leaves = iter(torch.autograd.grad(loss, train.leaves(params)))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        tree_map(lambda _: next(leaves), params)


@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch, chunk):
    jcfg, tcfg = configs(arch, ce_chunk=chunk)
    p = numpy_params(jcfg)
    data = inputs(jcfg)
    jm = JModel(jcfg)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda q: jm.loss(q, jx(data)), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, p))
    tp = train.trainable(params_from_numpy(p, "cpu"))
    loss, met, grads = grads_of(Model(tcfg), tp, tx(data))
    assert loss.dtype == F32 and loss.shape == ()
    assert abs(float(loss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    assert abs(float(met["ce"]) - float(jmet["ce"])) <= \
        1e-6 * abs(float(jmet["ce"]))
    assert abs(float(met["aux"]) - float(jmet["aux"])) <= \
        1e-6 * abs(float(jmet["aux"]))
    assert (float(met["aux"]) > 0) == (tcfg.n_experts > 0)
    got, want = dict(paths(grads)), dict(paths(jgrads))
    assert sorted(got) == sorted(want)
    limit = GRAD_REL.get(arch, 1e-4)
    errs = {name: rel(got[name], want[name]) for name in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= limit, f"{arch}: {worst} {errs[worst]}"


def test_tied_head_gets_its_gradient_in_the_graph():
    """``Model.head``'s kept copy of the tied embedding's transpose is
    not what ``loss`` uses: after a forward has made that copy, the
    embedding's gradient still holds the head's part."""
    _, tcfg = configs("qwen3-0.6b")
    model = Model(tcfg)
    params = train.trainable(model.init(torch.Generator().manual_seed(0)))
    tokens = torch.randint(0, tcfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.forward(params, tokens)
    kept = model._tied["head"][2]
    _, _, grads = grads_of(model, params, {"tokens": tokens})
    # rows of tokens absent from the batch get the head's gradient only
    absent = torch.ones(tcfg.vocab_size, dtype=torch.bool)
    absent[tokens.flatten()] = False
    assert absent.any()
    assert float(grads["embed"]["embedding"][absent].abs().max()) > 0
    assert model._tied["head"][2] is kept


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-0.6b",
                                  "gemma3-27b"])
def test_train_step_matches_jax_over_two_adamw_steps(arch):
    jcfg, tcfg = configs(arch)
    tcfg = tcfg.replace(remat=False)
    p = numpy_params(jcfg)
    jo = jopt.AdamW(schedule=jopt.cosine_schedule(3e-3, 2, 20))
    to = topt.AdamW(schedule=topt.cosine_schedule(3e-3, 2, 20))
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = train.trainable(params_from_numpy(p, "cpu"))
    jstate = {"params": jp, "opt": jo.init(jp)}
    state = {"params": tp, "opt": to.init(tp)}
    jstep = jax.jit(jtrain.make_train_step(JModel(jcfg), jo, None))
    step = train.make_train_step(
        Model(tcfg, impl=ops.differentiable()), to, None)
    for i in range(2):
        data = inputs(jcfg, seed=10 + i)
        jstate, jmet = jstep(jstate, jx(data))
        state, met = step(state, tx(data))
        assert set(met) == {"loss", "ce", "aux", "lr", "grad_norm"}
        assert float(met["lr"]) == float(jmet["lr"])
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= \
            1e-6 * float(jmet["loss"])
        assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) <= \
            2e-4 * float(jmet["grad_norm"])
    assert state["opt"]["step"].dtype == torch.int32
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 2
    for part in ("params", "m", "v"):
        got = state["params"] if part == "params" else state["opt"][part]
        want = jstate["params"] if part == "params" else \
            jstate["opt"][part]
        want = dict(paths(want))
        for name, g in paths(got):
            assert rel(g, want[name]) <= 1e-3, f"{arch} {part}{name}"
    for _, leaf in paths(state["params"]):
        assert leaf.is_leaf and leaf.requires_grad


def test_train_loop_reduces_loss_on_cpu():
    out = train.train_loop("smollm-360m", steps=25, batch=8, seq=48,
                           lr=3e-3, log=lambda *a: None, device="cpu")
    first = np.mean(out["losses"][:3])
    last = np.mean(out["losses"][-3:])
    assert last < first * 0.8, (first, last)
    assert not out["stalled"]
    assert all(np.isfinite(out["losses"])) and len(out["losses"]) == 25


def test_train_loop_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train.train_loop("smollm-360m", steps=1, batch=1, seq=8)


def test_train_main_on_cpu(capsys):
    train.main(["--arch", "qwen3-0.6b", "--steps", "3", "--batch", "2",
                "--seq", "12", "--device", "cpu"])
    assert "final loss:" in capsys.readouterr().out


def test_train_step_rejects_rules():
    """The step takes rules since the sharding slice: with ``PROD_RULES``
    on plain tensors its loss and new parameters are the unruled step's
    bit for bit.  (The name dates from when rules raised; it is kept so
    that the test's record runs on.)"""
    from repro_torch.models.common import PROD_RULES
    from repro_torch.optim.optimizers import AdamW, constant_schedule
    cfg = reduced(get_config("smollm-360m")).replace(dtype=torch.float32)
    model = Model(cfg)
    opt = AdamW(schedule=constant_schedule(1e-3))
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))}
    outs = []
    for rules in (None, PROD_RULES):
        params = train.trainable(
            model.init(torch.Generator().manual_seed(0)))
        state = {"params": params, "opt": opt.init(params)}
        outs.append(train.make_train_step(model, opt, rules)(state, batch))
    assert torch.equal(outs[0][1]["loss"], outs[1][1]["loss"])
    for a, b in zip(train.leaves(outs[0][0]["params"]),
                    train.leaves(outs[1][0]["params"])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# opaque kernels: what autograd sees of a ctypes kernel on the card
# ---------------------------------------------------------------------------

class Opaque:
    """The plain versions, each result computed under ``torch.no_grad()``
    and detached, as a kernel writes into a fresh tensor; each call
    counted."""

    def __init__(self):
        self.n = dict.fromkeys(("matmul", "fused_add_rmsnorm",
                                "flash_attention"), 0)

    def __getattr__(self, name):
        fn = getattr(F.PLAIN, name)

        def call(*args, **kwargs):
            self.n[name] += 1
            with torch.no_grad():
                out = fn(*args, **kwargs)
            if isinstance(out, tuple):
                return tuple(t.detach() for t in out)
            return out.detach()
        return call


def _setup(arch):
    _, cfg = configs(arch)
    cfg = cfg.replace(remat=False)
    params = train.trainable(
        Model(cfg).init(torch.Generator().manual_seed(0)))
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    return cfg, params, {"tokens": tokens}


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-0.6b",
                                  "gemma3-27b"])
def test_opaque_kernels_train_through_the_autograd_functions(arch):
    cfg, params, batch = _setup(arch)
    opaque = Opaque()
    loss, _, grads = grads_of(Model(cfg, impl=ops.differentiable(opaque)),
                              params, batch)
    n = cfg.n_layers
    assert opaque.n == {"matmul": 3 * (7 * n + 1),
                        "fused_add_rmsnorm": 2 * n + 1,
                        "flash_attention": n}
    want_loss, _, want = grads_of(Model(cfg, impl=F.PLAIN), params, batch)
    assert float(loss) == float(want_loss)
    want = dict(paths(want))
    for name, g in paths(grads):
        assert rel(g, want[name]) <= 1e-6, name


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b",
                                  "granite-moe-1b-a400m"])
def test_opaque_kernels_train_the_mixers(arch):
    """The Mamba2, RG-LRU and MoE layers' products through
    ``ops.differentiable`` train as the plain route does."""
    cfg, params, batch = _setup(arch)
    opaque = Opaque()
    loss, _, grads = grads_of(Model(cfg, impl=ops.differentiable(opaque)),
                              params, batch)
    calls = kernel_calls(cfg, prefill=True)
    calls["matmul"] *= 3
    assert opaque.n == calls
    want_loss, _, want = grads_of(Model(cfg, impl=F.PLAIN), params, batch)
    assert float(loss) == float(want_loss)
    want = dict(paths(want))
    for name, g in paths(grads):
        assert rel(g, want[name]) <= 1e-6, name


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-0.6b"])
def test_opaque_kernels_called_directly_leave_no_gradient(arch):
    cfg, params, batch = _setup(arch)
    loss, _ = Model(cfg, impl=Opaque()).loss(params, batch)
    assert not loss.requires_grad
    with pytest.raises(RuntimeError):
        torch.autograd.grad(loss, train.leaves(params))


def test_counting_impl_sees_a_chunked_step():
    """With ``ce_chunk`` the head runs once a chunk forward, once more a
    chunk in the backward's recompute, and dX and dW a chunk."""
    cfg, params, batch = _setup("smollm-360m")
    cfg = cfg.replace(ce_chunk=6)
    opaque = Opaque()
    grads_of(Model(cfg, impl=ops.differentiable(opaque)), params, batch)
    n, chunks = cfg.n_layers, 3                  # 15 targets in chunks of 6
    assert opaque.n == {"matmul": 3 * 7 * n + 4 * chunks,
                        "fused_add_rmsnorm": 2 * n + 1,
                        "flash_attention": n}


def test_kernel_counters_stay_at_zero_on_the_cpu():
    before = {k: c.launches for k, c in ops.launch_counters().items()}
    cfg, params, batch = _setup("smollm-360m")
    grads_of(Model(cfg, impl=ops.differentiable()), params, batch)
    assert {k: c.launches for k, c in ops.launch_counters().items()} == \
        before

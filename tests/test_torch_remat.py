"""Layer rematerialisation in the port (``models/remat.py``,
``cfg.remat`` and ``cfg.remat_policy`` in ``models/transformer.py``)
against the JAX package's ``jax.checkpoint`` of each layer group, on the
CPU at ``reduced`` size in float32, from the same numpy weights and
tokens:

* ``Model.loss`` and every gradient against ``jax.grad`` of the JAX
  package's ``Model.loss`` under the same ``remat`` and
  ``remat_policy``: ``full`` on all ten configs (whisper's encoder layers
  checkpointed too), all three policies on qwen3-0.6b, granite-moe-1b,
  mamba2-130m, recurrentgemma-9b (a group of 3 layers and a remainder)
  and llama4 (a group of 2), within ``tests/test_torch_train.py``'s
  limits (1e-6 relative on the loss, ``GRAD_REL`` else 1e-4 on each
  gradient);
* the port's loss and gradients bit-equal with and without remat, under
  each policy and a policy name the reference does not know (which is
  ``full``), through ``ops.differentiable``;
* the MoE choices: under recompute a recording ``Routing`` keeps one
  entry a MoE layer, equal to those of a step without remat, and a
  pinned replay trains (each entry taken once) to the same bits;
* the launches of a step under each policy (``chip_smoke.
  train_launches``) equal the calls of a stand-in whose kernels a
  ``TorchDispatchMode`` cannot see, as a ``ctypes`` launch is unseen;
* each group's recompute runs inside ``Model.recompute_span`` and makes
  ``recompute_launches``' launches there;
* serving: with grad off, or with a cache, nothing is checkpointed and
  a ``remat=True`` config makes the calls ``remat=False`` makes.
"""
import contextlib

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import (TorchDispatchMode,  # noqa: E402
                                          _disable_current_modes)

from test_torch_decode import ARCHS, inputs, jx, numpy_params, tx  # noqa: E402
from test_torch_serve import Counting, _smoke  # noqa: E402
from test_torch_train import GRAD_REL, grads_of, paths, rel  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import forward as F  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import remat as REMAT  # noqa: E402
from repro_torch.models.moe import Routing  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

SMOKE = _smoke()
POLICIES = ("full", "save_dots", "save_mixer")
# the configs every policy runs on: a dense group of one layer, MoE, SSD,
# a group of three (RG-LRU, RG-LRU, attention) with a remainder, and a
# group of two (attention + MoE, attention)
ALL_POLICIES = ("qwen3-0.6b", "granite-moe-1b-a400m", "mamba2-130m",
                "recurrentgemma-9b", "llama4-maverick-400b-a17b")
F32 = torch.float32


def _cases():
    out = [(arch, "full") for arch in ARCHS]
    out += [(arch, p) for arch in ALL_POLICIES for p in POLICIES[1:]]
    return out


def _port(arch, remat=True, policy="full"):
    return reduced(get_config(arch)).replace(dtype=F32, remat=remat,
                                             remat_policy=policy)


@pytest.mark.parametrize("arch,policy", _cases())
def test_loss_and_gradients_match_jax_under_remat(arch, policy):
    jcfg = jreduced(jget_config(arch)).replace(dtype=jnp.float32,
                                               remat=True,
                                               remat_policy=policy)
    p = numpy_params(jcfg)
    data = inputs(jcfg)
    jm = JModel(jcfg)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda q: jm.loss(q, jx(data)), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, p))
    tp = train.trainable(params_from_numpy(p, "cpu"))
    loss, met, grads = grads_of(Model(_port(arch, policy=policy)), tp,
                                tx(data))
    for got, want in ((loss, jloss), (met["ce"], jmet["ce"]),
                      (met["aux"], jmet["aux"])):
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    got, want = dict(paths(grads)), dict(paths(jgrads))
    assert sorted(got) == sorted(want)
    errs = {name: rel(got[name], want[name]) for name in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL.get(arch, 1e-4), \
        f"{arch} {policy}: {worst} {errs[worst]}"


def _setup(arch, seq=16):
    cfg = _port(arch, remat=False)
    params = train.trainable(
        Model(cfg).init(torch.Generator().manual_seed(0)))
    data = inputs(cfg, seq=seq)
    return cfg, params, tx(data)


def _step(model, params, batch, routing=None):
    loss, _ = model.loss(params, batch, routing=routing)
    return loss.detach(), torch.autograd.grad(loss, train.leaves(params))


def _bit_equal(a, b) -> bool:
    return torch.equal(a[0], b[0]) and len(a[1]) == len(b[1]) and all(
        torch.equal(x, y) for x, y in zip(a[1], b[1]))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m",
                                  "mamba2-130m", "recurrentgemma-9b",
                                  "llama4-maverick-400b-a17b",
                                  "whisper-tiny", "pixtral-12b"])
def test_gradients_bit_equal_with_and_without_remat(arch):
    cfg, params, batch = _setup(arch)
    off = _step(Model(cfg, impl=ops.differentiable()), params, batch)
    for policy in POLICIES + ("no_such_policy",):
        on = _step(Model(cfg.replace(remat=True, remat_policy=policy),
                         impl=ops.differentiable()), params, batch)
        assert _bit_equal(on, off), policy


class Invisible:
    """The plain versions, each call counted and computed with every
    dispatch mode popped: a ``TorchDispatchMode`` (PyTorch's selective
    checkpointing runs on one) sees none of its ops, as it sees nothing
    of a kernel launched through ``ctypes``; results detached."""

    def __init__(self):
        self.n = dict.fromkeys(("matmul", "fused_add_rmsnorm",
                                "flash_attention"), 0)

    def __getattr__(self, name):
        fn = getattr(F.PLAIN, name)

        def call(*args, **kwargs):
            self.n[name] += 1
            with torch.no_grad(), _disable_current_modes():
                out = fn(*args, **kwargs)
            if isinstance(out, tuple):
                return tuple(t.detach() for t in out)
            return out.detach()
        return call


class Seen(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def test_the_stand_in_is_invisible_to_a_dispatch_mode():
    a, b = torch.ones(4, 3), torch.ones(3, 5)
    with Seen() as seen:
        out = Invisible().matmul(a, b)
    assert torch.equal(out, torch.full((4, 5), 3.0))
    assert not {"mm", "matmul", "bmm", "addmm"} & set(seen.ops)
    with Seen() as seen:
        F.PLAIN.matmul(a, b)
    assert "mm" in seen.ops


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_launches_of_a_step_under_each_policy(arch, policy):
    """``train_launches`` of a remat config equals the calls of a step
    with the frontend inputs; the recompute's share differs by policy,
    and the gradients equal the plain route's bit for bit."""
    cfg, params, batch = _setup(arch, seq=10)
    cfg = cfg.replace(remat=True, remat_policy=policy)
    unseen = Invisible()
    got = _step(Model(cfg, impl=ops.differentiable(unseen)), params, batch)
    assert unseen.n == SMOKE.train_launches(cfg)
    want = _step(Model(cfg.replace(remat=False),
                       impl=ops.differentiable(Invisible())), params, batch)
    assert _bit_equal(got, want)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m",
                                  "recurrentgemma-9b", "whisper-tiny"])
def test_the_recompute_runs_inside_the_models_span(arch, policy):
    """``Model.recompute_span`` is entered once a layer group's recompute
    (and an encoder layer's), and the launches inside it are
    ``chip_smoke.recompute_launches``' for the policy."""
    cfg, params, batch = _setup(arch, seq=10)
    cfg = cfg.replace(remat=True, remat_policy=policy)
    unseen = Invisible()
    spans, inside = [], dict.fromkeys(unseen.n, 0)

    @contextlib.contextmanager
    def span():
        before = dict(unseen.n)
        try:
            yield
        finally:
            spans.append(policy)
            for name in inside:
                inside[name] += unseen.n[name] - before[name]
    _step(Model(cfg, impl=ops.differentiable(unseen), recompute_span=span),
          params, batch)
    assert len(spans) == cfg.n_layers // len(cfg.pattern) + \
        cfg.encoder_layers
    assert inside == SMOKE.recompute_launches(cfg)


def test_unkept_is_the_taped_impls_own():
    tape = REMAT.Tape("save_dots")
    impl = ops.differentiable()
    assert REMAT.unkept(REMAT.taped(impl, tape)) is impl
    assert REMAT.unkept(impl) is impl


def test_recompute_launches_by_policy_at_full_size():
    """granite-moe-1b (24 one-layer groups of attention + 32-expert MoE):
    ``full`` runs every forward GEMM again (no group ends on a GEMM),
    ``save_dots`` the 96 expert GEMMs a layer, ``save_mixer`` all but
    the output projection; Qwen3-0.6B (28 dense groups) keeps its down
    projection under every policy."""
    granite = get_config("granite-moe-1b-a400m")
    qwen = get_config("qwen3-0.6b")
    want = {"granite-moe-1b-a400m": {"full": 24 * 101, "save_dots": 24 * 96,
                                     "save_mixer": 24 * 100},
            "qwen3-0.6b": {"full": 28 * 6, "save_dots": 0,
                           "save_mixer": 28 * 5}}
    for cfg in (granite, qwen):
        n = cfg.n_layers
        for policy, gemms in want[cfg.name].items():
            assert SMOKE.recompute_launches(
                cfg.replace(remat_policy=policy)) == {
                    "matmul": gemms, "fused_add_rmsnorm": 2 * n,
                    "flash_attention": n}
        assert SMOKE.recompute_launches(cfg.replace(remat=False)) == \
            dict.fromkeys(("matmul", "fused_add_rmsnorm",
                           "flash_attention"), 0)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "llama4-maverick-400b-a17b"])
def test_moe_choices_under_recompute(arch, policy):
    cfg, params, batch = _setup(arch, seq=40)
    plain = Routing()
    off = _step(Model(cfg), params, batch, plain)
    model = Model(cfg.replace(remat=True, remat_policy=policy))
    chosen = Routing()
    on = _step(model, params, batch, chosen)
    assert _bit_equal(on, off)
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    assert len(chosen.choices) == len(plain.choices) == moe_layers > 0
    assert all(torch.equal(a, b) for a, b in zip(chosen.choices,
                                                   plain.choices))
    replay = chosen.pinned()
    again = _step(model, params, batch, replay)
    assert replay.calls == moe_layers
    assert _bit_equal(again, off)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m",
                                  "whisper-tiny"])
def test_serving_is_never_checkpointed(arch, monkeypatch):
    cfg, params, batch = _setup(arch, seq=10)
    extras = {k: v for k, v in batch.items() if k != "tokens"}
    tokens = batch["tokens"]

    def calls(c):
        counting = Counting()
        model = Model(c, impl=counting)
        with torch.no_grad():
            model.forward(params, tokens, **extras)
        _, cache = model.prefill(params, tokens[:, :8], max_len=16
                                 + c.n_patches, **extras)
        model.decode_step(params, tokens[:, 8:9], cache)
        return counting.n

    off = calls(cfg)

    def refuse(*args, **kwargs):
        raise AssertionError("checkpointed while serving")
    monkeypatch.setattr(REMAT, "checkpointed", refuse)
    for policy in POLICIES:
        assert calls(cfg.replace(remat=True, remat_policy=policy)) == off
    assert REMAT.wanted(cfg.replace(remat=True), None)
    with torch.no_grad():
        assert not REMAT.wanted(cfg.replace(remat=True), None)
    assert not REMAT.wanted(cfg.replace(remat=True), {})

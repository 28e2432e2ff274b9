"""The port's cost walker (``repro_torch.launch.costmodel``) against the
JAX package's (``repro.launch.costmodel.jaxpr_cost``) and against
``torch.utils.flop_counter.FlopCounterMode``, on the CPU:

* the four walker cases of ``tests/test_costmodel.py`` on the port (the
  scanned body becomes a Python loop of 17 steps, ``jax.checkpoint``
  becomes ``torch.utils.checkpoint``);
* exact equality with ``jaxpr_cost`` on a GEMM (FLOPs and bytes), three
  convolutions (FLOPs and bytes) and two convolution gradients (FLOPs);
* ``tests/test_simulator_vs_jax.py``'s three cases on the port: SimDIT's
  conv, FC and Table V backward MACs against the walker's FLOPs;
* for each of the ten configs at ``reduced`` size, over a train step, a
  prefill and a decode step of the plain route (remat off on both
  sides): the walker's GEMM FLOPs equal ``FlopCounterMode``'s over the
  same trace, and equal the JAX step's ``dot_general`` FLOPs, each
  difference named by op (below);
* a train step of qwen3-0.6b and granite-moe-1b under each
  ``remat_policy``, both sides alike: the same equalities, the
  recompute included, and the policies ordered as the reference's (off
  < ``save_dots`` < ``save_mixer`` < ``full``);
* ``dryrun.depth_cost`` (two traces, extrapolated) equals the full trace
  at a reduced depth of several periods;
* an in-place KV-cache write counts the rows it stores.

Where the two walkers' GEMM FLOPs differ, by op:
* a prefill: the reference attends over the whole cache buffer (its
  ``max_len`` rows, 8 more than the sequence), the port over the fresh
  keys alone: 4 * B * T * 8 * H * hd a self-attention layer;
* a contraction over an axis of length 1 (top-1 MoE's one-hot einsums,
  Mamba2's outer products): a ``dot_general`` in JAX, a broadcast
  multiply in PyTorch's einsum; not counted as a GEMM on either side;
* a training step of mamba2: the SSD's backward (JAX transposes its
  three-operand einsums into more contractions), held equal to the
  difference of ``ssd_chunked``'s gradient alone, once a layer;
* a training step of llama4: the MoE layer's backward (the combine
  einsum's gradient for the top-1 gate), held equal to the difference of
  ``apply_moe``'s gradient alone, once a MoE layer;
* a training step of a MoE model under ``save_dots``: the one-hot
  dispatch einsum, which the reference keeps and the port recomputes
  (``models/remat.py``), once a MoE layer.

Tolerances: every comparison is exact (FLOP counts are integers).
"""
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import costmodel as JC  # noqa: E402
from repro.launch.serve import make_prefill_step as jprefill  # noqa: E402
from repro.launch.serve import make_serve_step as jserve  # noqa: E402
from repro.launch.train import make_train_step as jtrain  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro.models.frontends import frontend_input_specs as jfis  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402
from repro.optim.optimizers import AdamW as JAdamW  # noqa: E402
from repro.optim.optimizers import constant_schedule as jconst  # noqa: E402

from repro_torch.configs import ARCHS, get_config, reduced  # noqa: E402
from repro_torch.core.backward import dw_conv, dx_conv  # noqa: E402
from repro_torch.core.layers import ConvLayer, fc  # noqa: E402
from repro_torch.kernels.forward import PLAIN  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.costmodel import (Cost, graph_cost, trace,  # noqa: E402
                                          walk)
from repro_torch.launch.train import leaves  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models.common import TensorSpec, tree_map  # noqa: E402
from repro_torch.models.frontends import frontend_input_specs  # noqa: E402


def meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


def sds(*shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


# ---- tests/test_costmodel.py on the port -----------------------------------

def test_dot_flops_exact():
    c = graph_cost(lambda x, y: x @ y, meta(64, 32), meta(32, 48))
    assert c.flops == 2 * 64 * 48 * 32
    assert c.gemm_flops == c.flops


def test_loop_multiplies_body():
    """The port's layer loop is a Python loop: the trace unrolls it, so a
    body run 17 times is counted 17 times."""
    def f(x, w):
        for _ in range(17):
            x = x @ w
        return x
    c = graph_cost(f, meta(64, 64), meta(64, 64))
    assert 17 * 2 * 64 ** 3 <= c.flops < 18 * 2 * 64 ** 3


def test_checkpoint_counts_recompute():
    """The gradient of a checkpointed function recomputes its forward:
    flops(grad with checkpoint) > flops(grad without)."""
    def f_plain(x, w):
        return torch.sum(torch.tanh(x @ w) @ w)

    def f_remat(x, w):
        return torch.sum(checkpoint(lambda x: torch.tanh(x @ w) @ w, x,
                                    use_reentrant=False))

    def grad_of(f):
        def g(x, w):
            return torch.autograd.grad(f(x, w), w)
        return g
    x, w = meta(128, 128), meta(128, 128, grad=True)
    assert graph_cost(grad_of(f_remat), x, w).flops > \
        graph_cost(grad_of(f_plain), x, w).flops


def test_bytes_reasonable_for_matmul():
    m = n = k = 256
    c = graph_cost(lambda x, y: x @ y, meta(m, k), meta(k, n))
    io = (m * k + k * n + m * n) * 4
    assert io <= c.bytes <= 3 * io


# ---- against the JAX walker ----------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(64, 32, 48), (128, 256, 8)])
def test_gemm_equals_jaxpr_cost(m, k, n):
    got = graph_cost(lambda x, y: x @ y, meta(m, k), meta(k, n))
    want = JC.jaxpr_cost(lambda x, y: x @ y, sds(m, k), sds(k, n))
    assert (got.flops, got.bytes) == (want.flops, want.bytes)


CONVS = [(2, 16, 32, 24, 3, 1), (1, 3, 224, 64, 7, 2), (4, 64, 14, 128, 1, 1)]


@pytest.mark.parametrize("n,ic,hw,oc,k,s", CONVS)
def test_conv_equals_jaxpr_cost(n, ic, hw, oc, k, s):
    got = graph_cost(lambda x, w: F.conv2d(x, w, stride=s),
                     meta(n, ic, hw, hw), meta(oc, ic, k, k))
    want = JC.jaxpr_cost(
        lambda x, w: jax.lax.conv_general_dilated(x, w, (s, s), "VALID"),
        sds(n, ic, hw, hw), sds(oc, ic, k, k))
    assert (got.flops, got.bytes) == (want.flops, want.bytes)
    assert got.gemm_flops == got.flops


@pytest.mark.parametrize("n,ic,hw,oc,k,s", [(2, 8, 16, 12, 3, 1),
                                             (2, 16, 32, 24, 3, 2)])
def test_conv_gradient_equals_jaxpr_cost(n, ic, hw, oc, k, s):
    """dX and dW of ``convolution_backward`` counted as the convolutions
    JAX's transpose builds (dX over x's positions, padding included)."""
    def grad(x, w):
        return torch.autograd.grad(F.conv2d(x, w, stride=s).sum(), (x, w))

    def jloss(x, w):
        return jax.lax.conv_general_dilated(x, w, (s, s), "VALID").sum()
    got = graph_cost(grad, meta(n, ic, hw, hw, grad=True),
                     meta(oc, ic, k, k, grad=True))
    want = JC.jaxpr_cost(jax.grad(jloss, argnums=(0, 1)),
                         sds(n, ic, hw, hw), sds(oc, ic, k, k))
    assert got.flops == want.flops


# ---- tests/test_simulator_vs_jax.py on the port ---------------------------------

@pytest.mark.parametrize("n,ic,hw_in,oc,k,s", CONVS)
def test_conv_macs_match_the_walker(n, ic, hw_in, oc, k, s):
    oh = (hw_in - k) // s + 1
    layer = ConvLayer(name="c", n=n, ic=ic, ih=hw_in, iw=hw_in, oc=oc,
                      oh=oh, ow=oh, kh=k, kw=k, s=s, has_bias=False)
    c = graph_cost(lambda x, w: F.conv2d(x, w, stride=s),
                   meta(n, ic, hw_in, hw_in), meta(oc, ic, k, k))
    assert c.flops == 2 * layer.macs


def test_fc_macs_match_the_walker():
    layer = fc("f", 8, 512, 1000, has_bias=False)
    c = graph_cost(lambda x, w: x @ w, meta(8, 512), meta(512, 1000))
    assert c.flops == 2 * layer.macs


def test_backward_conv_macs_match_the_walker():
    """The Table V-transformed backward convs' MACs equal the traced
    gradient's convolution FLOPs exactly (stride 1: no dilation zeros);
    the walker adds the sum's cotangent (a few K elementwise FLOPs)."""
    n, ic, hw_in, oc, k = 2, 8, 16, 12, 3
    oh = hw_in - k + 1
    f = ConvLayer(name="f", n=n, ic=ic, ih=hw_in, iw=hw_in, oc=oc, oh=oh,
                  ow=oh, kh=k, kw=k, s=1, has_bias=False)

    def grad(x, w):
        y = F.conv2d(x, w)
        return (y,) + torch.autograd.grad(y.sum(), (x, w))
    g = graph_cost(grad, meta(n, ic, hw_in, hw_in, grad=True),
                   meta(oc, ic, k, k, grad=True))
    analytic = 2 * (f.macs + dx_conv(f).macs + dw_conv(f).macs)
    assert g.gemm_flops == analytic
    assert abs(g.flops - analytic) / analytic < 0.005


# ---- the ten configs: FlopCounterMode and the JAX step ------------------------------

B, S = 2, 32


def _jax_dot_flops(jaxpr, mult=1.0) -> float:
    """``dot_general`` FLOPs of a jaxpr (scan bodies times their trip
    count), leaving out contractions over a length-1 axis."""
    total = 0.0
    for e in jaxpr.eqns:
        name = e.primitive.name
        if name == "scan":
            total += _jax_dot_flops(e.params["jaxpr"].jaxpr,
                                    mult * e.params["length"])
            continue
        sub = next((e.params[k] for k in ("jaxpr", "call_jaxpr",
                                          "fun_jaxpr") if k in e.params),
                   None)
        if sub is not None:
            total += _jax_dot_flops(getattr(sub, "jaxpr", sub), mult)
            continue
        if name == "dot_general":
            contract = e.params["dimension_numbers"][0][0]
            k = 1
            for d in contract:
                k *= e.invars[0].aval.shape[d]
            if k > 1:
                total += JC._dot_flops(e) * mult
    return total


def _jax_step(arch, kind, remat=False, policy="full"):
    """The JAX step of ``kind`` on the reduced config (remat off unless
    asked): its jaxpr, and its ``jaxpr_cost``."""
    cfg = jreduced(jget_config(arch)).replace(remat=remat,
                                              remat_policy=policy)
    model = JModel(cfg)
    params = model.abstract()
    batch = {"tokens": sds(B, S, dtype=jnp.int32), **jfis(cfg, B)}
    if kind == "train":
        opt = JAdamW(schedule=jconst(1e-4))
        state = {"params": params, "opt": jax.eval_shape(opt.init, params)}
        fn, args = jtrain(model, opt, None), (state, batch)
    elif kind == "prefill":
        fn, args = jprefill(model, None, S + cfg.n_patches + 8), (params,
                                                                  batch)
    else:
        fn, args = jserve(model, None), (
            params, model.make_cache(B, S, abstract=True),
            sds(B, 1, dtype=jnp.int32))
    return jax.make_jaxpr(fn)(*args).jaxpr, JC.jaxpr_cost(fn, *args)


def _port_step(arch, kind, remat=False, policy="full"):
    cfg = reduced(get_config(arch)).replace(remat=remat,
                                            remat_policy=policy)
    specs = None
    if kind != "decode":
        specs = {"tokens": TensorSpec((B, S), torch.int32),
                 **frontend_input_specs(cfg, B)}
    fn, args = dryrun.step_program(cfg, kind, B, S, specs=specs)
    return cfg, fn, args


def _ssd_backward_delta(cfg) -> float:
    """JAX's GEMM FLOPs less the port's for ``ssd_chunked``'s forward and
    gradient alone, at the model's shapes."""
    di, h, n = SSM.ssm_dims(cfg)
    shapes = [((B, S, h, cfg.ssm_head_dim), cfg.dtype),
              ((B, S, h), torch.float32), ((h,), cfg.dtype),
              ((B, S, n), cfg.dtype), ((B, S, n), cfg.dtype)]
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
    jaxpr = jax.make_jaxpr(jax.grad(
        lambda *a: JSSM.ssd_chunked(*a, 256)[0].sum(),
        argnums=tuple(range(5))))(*[sds(*s, dtype=jdt[d])
                                    for s, d in shapes]).jaxpr

    def grad(*a):
        return torch.autograd.grad(SSM.ssd_chunked(*a, 256)[0].sum(), a)
    port = graph_cost(grad, *[meta(*s, dtype=d, grad=True)
                              for s, d in shapes])
    return _jax_dot_flops(jaxpr) - port.gemm_flops


def _moe_backward_delta(arch) -> float:
    """The same for ``apply_moe``'s output and aux loss and its gradient
    for the layer's parameters and input."""
    cfg, jcfg = reduced(get_config(arch)), jreduced(jget_config(arch))
    jparams = jax.tree_util.tree_map(
        lambda d: sds(*d.shape, dtype=jnp.bfloat16), JMOE.moe_defs(jcfg),
        is_leaf=lambda x: hasattr(x, "axes"))

    def jloss(p, x):
        y, aux = JMOE.apply_moe(jcfg, p, x, None)
        return y.astype(jnp.float32).sum() + aux
    jaxpr = jax.make_jaxpr(jax.grad(jloss, argnums=(0, 1)))(
        jparams, sds(B, S, cfg.d_model, dtype=jnp.bfloat16)).jaxpr
    params = tree_map(lambda d: meta(*d.shape, dtype=torch.bfloat16,
                                     grad=True), MOE.moe_defs(cfg))

    def grad(p, x):
        y, aux = MOE.apply_moe(cfg, p, x, None, impl=PLAIN)
        return torch.autograd.grad(y.float().sum() + aux,
                                   leaves(p) + [x])
    port = graph_cost(grad, params, meta(B, S, cfg.d_model,
                                         dtype=torch.bfloat16, grad=True))
    return _jax_dot_flops(jaxpr) - port.gemm_flops


def _named_delta(arch, kind, cfg) -> float:
    """JAX's GEMM FLOPs less the port's, by the ops named above."""
    attn_layers = sum(1 for k in cfg.layer_kinds()
                      if k.split("+")[0] == "attn")
    if kind == "prefill":
        rows = S + cfg.n_patches
        return 4.0 * B * rows * 8 * cfg.n_heads * cfg.hd * attn_layers
    if kind == "train" and arch == "mamba2-130m":
        return cfg.n_layers * _ssd_backward_delta(cfg)
    if kind == "train" and arch.startswith("llama4"):
        moe_layers = sum(1 for k in cfg.layer_kinds() if k.endswith("+moe"))
        return moe_layers * _moe_backward_delta(arch)
    return 0.0


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gemm_flops_of_every_config(arch, kind, capsys):
    cfg, fn, args = _port_step(arch, kind)
    gm = trace(fn, *args)
    got = walk(gm.graph)
    with FlopCounterMode(display=False) as counter:
        gm(*args)
    assert got.gemm_flops == counter.get_total_flops()
    jaxpr, jcost = _jax_step(arch, kind)
    assert _jax_dot_flops(jaxpr) - got.gemm_flops == \
        _named_delta(arch, kind, cfg)
    with capsys.disabled():
        print(f"\n{arch} {kind} (reduced, {B} x {S}): port FLOPs "
              f"{got.flops:.0f} bytes {got.bytes:.0f}; JAX jaxpr_cost "
              f"FLOPs {jcost.flops:.0f} bytes {jcost.bytes:.0f}")


# ---- a training step under each remat policy ------------------------------------------

REMAT = ("off", "save_dots", "save_mixer", "full")
_remat_walks = {}


def _remat_walk(arch, policy):
    """``(port GEMM FLOPs, FlopCounterMode's, JAX dot FLOPs)`` of a train
    step of the reduced config under ``policy`` (``off``: no remat), both
    packages alike; each traced once a module."""
    key = (arch, policy)
    if key not in _remat_walks:
        kw = dict(remat=policy != "off",
                  policy="full" if policy == "off" else policy)
        _, fn, args = _port_step(arch, "train", **kw)
        gm = trace(fn, *args)
        with FlopCounterMode(display=False) as counter:
            gm(*args)
        jaxpr, _ = _jax_step(arch, "train", **kw)
        _remat_walks[key] = (walk(gm.graph).gemm_flops,
                             counter.get_total_flops(),
                             _jax_dot_flops(jaxpr))
    return _remat_walks[key]


def _dispatch_flops(cfg) -> float:
    """The one-hot dispatch einsum (``nbec,nbd->necd``) of a MoE layer's
    forward at the test's B x S: ``save_dots`` keeps it in the reference
    (no batch dimension inside its map over the token blocks) and the
    port recomputes it (batched over the blocks)."""
    tokens = B * S
    blk = min(cfg.moe_block, tokens)
    nblk = -(-tokens // blk)
    return 2.0 * nblk * blk * cfg.n_experts * MOE._capacity(cfg) \
        * cfg.d_model


@pytest.mark.parametrize("policy", REMAT[1:])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m"])
def test_gemm_flops_of_a_train_step_under_remat(arch, policy):
    """The recompute each policy leaves counted as the reference counts
    it: the port's GEMM FLOPs equal ``FlopCounterMode``'s and the JAX
    step's dots, less the dispatch einsum ``save_dots`` recomputes in
    the port alone, once a MoE layer."""
    got, counted, jax_dots = _remat_walk(arch, policy)
    assert got == counted
    cfg = reduced(get_config(arch))
    moe_layers = sum(1 for k in cfg.layer_kinds() if k.endswith("+moe"))
    delta = -moe_layers * _dispatch_flops(cfg) \
        if moe_layers and policy == "save_dots" else 0.0
    assert jax_dots - got == delta


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m"])
def test_remat_policies_order_the_recompute_as_the_reference(arch):
    """off < save_dots < save_mixer < full, in both walkers."""
    walks = [_remat_walk(arch, p) for p in REMAT]
    for side in (0, 2):
        flops = [w[side] for w in walks]
        assert flops == sorted(set(flops)), (side, flops)


# ---- the dry run's depth extrapolation ------------------------------------------------

@pytest.mark.parametrize("arch,kind", [("qwen3-0.6b", "train"),
                                       ("gemma3-27b", "prefill"),
                                       ("recurrentgemma-9b", "prefill"),
                                       ("llama4-maverick-400b-a17b",
                                        "decode")])
def test_depth_cost_equals_the_full_trace(arch, kind):
    """Two traces (one and two periods, plus the remainder) extrapolated
    to three periods equal the three-period trace: FLOPs, GEMM FLOPs and
    bytes, within float rounding (1e-12 relative).  A training step's
    optimizer over the layer-stacked leaves grows with depth too."""
    cfg = reduced(get_config(arch))
    p = dryrun.period(cfg)
    cfg = cfg.replace(n_layers=3 * p + cfg.n_layers % len(cfg.pattern))
    full = graph_cost(*_prog(cfg, kind))
    scaled = dryrun.depth_cost(cfg, lambda c: graph_cost(*_prog(c, kind)))
    for field in ("flops", "gemm_flops", "bytes"):
        assert getattr(scaled, field) == pytest.approx(
            getattr(full, field), rel=1e-12)


def _prog(cfg, kind):
    fn, args = dryrun.step_program(cfg, kind, B, S)
    return (fn,) + tuple(args)


def test_cache_write_counts_the_rows_it_stores():
    """A decode step's ``index_copy_`` into a (L, B, T, KV, hd) cache
    writes its new row and reads it, not the buffer; the buffer read by
    the attention after it counts once."""
    cache = meta(4, 2, 1024, 2, 8)
    row = meta(2, 1, 2, 8)
    index = meta(1, dtype=torch.int64)

    def write(cache, index, row):
        cache[1].index_copy_(1, index, row)
        return cache
    c = graph_cost(write, cache, index, row)
    # the row read and written, the index read
    assert c.bytes == 2 * row.numel() * 4 + 8
    assert c.flops == 0
    assert Cost(1.0, 2.0, 3.0) - Cost(1.0, 1.0, 1.0) == Cost(0.0, 1.0, 2.0)

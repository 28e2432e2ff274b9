"""The port's MoE, Mamba2 and RG-LRU mixers (``repro_torch.models.moe``,
``ssm``, ``rglru``) against the JAX package's, function for function, on
the same numpy inputs (seeded), float32 on the CPU: the cases of
``tests/test_models_units.py`` as comparisons with the JAX functions.

Tolerances: 2e-5 absolute and relative for one layer's outputs (float32
products of 16-64 terms summed in another order), 1e-6 for the MoE aux
loss (a mean of E products), 1e-4 for the chunked SSD scan and the
RG-LRU scan against a step loop (the JAX package's own limits in
``tests/test_models_units.py``), 1e-5 where the port's scan meets the
JAX scan (both float32 trees of at most log2 S levels).  Routing is
discrete: the top-k choices, capacity drops and dropped rows are held
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import moe as JMOE  # noqa: E402
from repro.models import rglru as JRG  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro.models.common import ModelConfig as JModelConfig  # noqa: E402
from repro.models.common import ParamDef as JParamDef  # noqa: E402
from repro_torch.kernels import forward as F  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import rglru as RG  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402

F32 = torch.float32
TOL = dict(atol=2e-5, rtol=2e-5)


def cfgs(**kw):
    """The same small configuration in both packages (float32)."""
    base = dict(name="m", family="moe", n_layers=1, d_model=16, n_heads=2,
                n_kv_heads=2, d_ff=32, vocab_size=11, n_experts=4, top_k=2,
                moe_block=32, ssm_state=8, ssm_head_dim=8, conv_width=4,
                rnn_width=24)
    base.update(kw)
    return (JModelConfig(dtype=jnp.float32, **base),
            ModelConfig(dtype=F32, **base))


def params(defs, seed=0, ones_noise=0.1):
    """Seeded numpy weights for a JAX ``ParamDef`` tree: normal leaves at
    their init's std, "ones" 1 + 0.1 N(0, 1), "zeros" 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)

    def leaf(d):
        z = rng.standard_normal(d.shape).astype(np.float32)
        if d.init == "ones":
            return np.float32(1) + np.float32(ones_noise) * z
        if d.init == "zeros":
            return np.float32(0.1) * z
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        return z * np.float32(d.scale / np.sqrt(max(1, fan_in)))
    return jax.tree_util.tree_map(leaf, defs,
                                  is_leaf=lambda x: isinstance(x, JParamDef))


def both_trees(p):
    return (jax.tree_util.tree_map(jnp.asarray, p),
            jax.tree_util.tree_map(torch.from_numpy, p))


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), **(tol or TOL))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_both(x, seed=0, **kw):
    jcfg, tcfg = cfgs(**kw)
    jp, tp = both_trees(params(JMOE.moe_defs(jcfg), seed))
    jy, jaux = JMOE.apply_moe(jcfg, jp, jnp.asarray(x), None)
    ty, taux = MOE.apply_moe(tcfg, tp, torch.from_numpy(x), None)
    return (jy, jaux), (ty, taux)


@pytest.mark.parametrize("dispatch", ["onehot", "scatter"])
@pytest.mark.parametrize("capacity", [0.25, 1.25, 4.0])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_matches_jax(dispatch, capacity, top_k):
    """Both dispatches, with drops (0.25, 1.25) and without (4.0), over
    two blocks of 32 tokens and a third padded with 16 zero rows."""
    x = randn(top_k, 2, 40, 16)
    (jy, jaux), (ty, taux) = moe_both(x, moe_dispatch=dispatch,
                                      moe_capacity=capacity, top_k=top_k)
    assert ty.dtype == F32 and tuple(ty.shape) == x.shape
    close(ty, jy)
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    # the same tokens dropped (rows of exact zeros)
    np.testing.assert_array_equal(
        (ty.abs().sum(-1) == 0).numpy(), np.asarray(jnp.abs(jy).sum(-1) == 0))


def test_moe_capacity_drops_tokens():
    """A tiny capacity factor drops tokens (zero rows), a huge one none;
    the port drops the tokens the JAX package drops."""
    x = randn(1, 1, 32, 16)
    counts = []
    for capacity in (0.10, 16.0):
        (jy, _), (ty, _) = moe_both(x, moe_capacity=capacity, top_k=1)
        dropped = (ty.abs().sum(-1) == 0).numpy()
        np.testing.assert_array_equal(dropped,
                                      np.asarray(jnp.abs(jy).sum(-1) == 0))
        counts.append(int(dropped.sum()))
    assert counts[0] > 0 and counts[1] == 0


def test_moe_capacity_from_cfg_block_not_actual_block():
    """With fewer tokens than ``moe_block`` the block shrinks but the
    capacity still comes from ``cfg.moe_block`` (a decode step of 4
    tokens keeps every choice at 1.25)."""
    _, tcfg = cfgs(moe_block=1024, n_experts=32, top_k=8)
    assert MOE._capacity(tcfg) == 320
    _, small = cfgs(moe_block=64, n_experts=8, top_k=2, moe_capacity=0.25)
    assert MOE._capacity(small) == 4     # int(4.0) rounded up to 4, min 4
    x = randn(3, 1, 4, 16)
    (jy, jaux), (ty, taux) = moe_both(x, moe_block=1024, moe_capacity=0.01)
    close(ty, jy)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)


def test_moe_scatter_equals_onehot():
    x = randn(3, 2, 24, 16)
    _, tcfg = cfgs(moe_capacity=0.5)
    tp = jax.tree_util.tree_map(torch.from_numpy,
                                params(JMOE.moe_defs(cfgs()[0])))
    xt = torch.from_numpy(x)
    y_oh, aux_oh = MOE.apply_moe(tcfg, tp, xt, None)
    y_sc, aux_sc = MOE.apply_moe(tcfg.replace(moe_dispatch="scatter"), tp,
                                 xt, None)
    close(y_sc, y_oh.numpy())
    assert float(aux_sc) == float(aux_oh)


def test_moe_topk_mass_normalized():
    """Identical tokens give identical outputs, each the renormalised
    top-k mix of its experts."""
    x = np.tile(randn(2, 1, 1, 16), (1, 8, 1))
    (jy, _), (ty, _) = moe_both(x, moe_capacity=16.0)
    close(ty[0, 0], ty[0, 7].numpy(), atol=1e-6, rtol=0)
    close(ty, jy)


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_moe_tied_probabilities_break_to_the_lower_index(top_k):
    """A zero router ties every probability: ``jax.lax.top_k`` takes the
    lowest indices, and so must the port (the choices decide the output,
    the capacity drops and the aux loss)."""
    jcfg, tcfg = cfgs(top_k=top_k, moe_capacity=1.0)
    p = params(JMOE.moe_defs(jcfg))
    p["router"][:] = 0.0
    jp, tp = both_trees(p)
    x = randn(4, 1, 20, 16)
    jy, jaux = JMOE.apply_moe(jcfg, jp, jnp.asarray(x), None)
    routing = MOE.Routing()
    ty, taux = MOE.apply_moe(tcfg, tp, torch.from_numpy(x), None,
                             routing=routing)
    idx = routing.choices[0]
    assert idx.shape == (1, 20, top_k)
    np.testing.assert_array_equal(idx.numpy(),
                                  np.broadcast_to(np.arange(top_k),
                                                  idx.shape))
    close(ty, jy)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)


def test_moe_padded_rows_tie_and_enter_the_aux_loss():
    """44 tokens in blocks of 32: the last block has 20 zero rows whose
    probabilities all tie; their choices count in the aux loss as the
    reference counts them."""
    x = randn(5, 2, 22, 16)
    (jy, jaux), (ty, taux) = moe_both(x, moe_capacity=4.0)
    close(ty, jy)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)


def test_moe_shared_expert_top1():
    """llama4's reduced shape: 8 experts, top-1, a shared expert."""
    x = randn(6, 2, 24, 64)
    kw = dict(d_model=64, d_ff=128, n_experts=8, top_k=1, moe_block=64,
              shared_expert=True)
    for dispatch in ("onehot", "scatter"):
        (jy, jaux), (ty, taux) = moe_both(x, moe_dispatch=dispatch, **kw)
        close(ty, jy)
        assert float(taux) == pytest.approx(float(jaux), rel=1e-6)


def test_moe_gradients_match_jax():
    """Gradients of a scalar of the output and the aux loss, for every
    weight and the input, against ``jax.grad`` (1e-5 relative)."""
    jcfg, tcfg = cfgs(moe_capacity=0.75, shared_expert=True)
    p = params(JMOE.moe_defs(jcfg))
    x = randn(7, 2, 20, 16)
    w = randn(8, 2, 20, 16)

    def jloss(q, xx):
        y, aux = JMOE.apply_moe(jcfg, q, xx, None)
        return jnp.sum(y * w) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = MOE.apply_moe(tcfg, tp, xt, None)
    (torch.sum(y * torch.from_numpy(w)) + aux).backward()
    for name, want in list(jg.items()) + [("x", jgx)]:
        got = (xt if name == "x" else tp[name]).grad.numpy()
        want = np.asarray(want)
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= 1e-5, (name, err)


def test_routing_replays_its_own_choices_bit_for_bit():
    """A MoE fed its own recorded choices computes the same bits; fed
    another input's choices it computes something else; a replay past
    the recorded calls raises."""
    _, tcfg = cfgs(moe_capacity=0.75)
    tp = jax.tree_util.tree_map(torch.from_numpy,
                                params(JMOE.moe_defs(cfgs()[0])))
    x = torch.from_numpy(randn(10, 2, 40, 16))
    other = torch.from_numpy(randn(11, 2, 40, 16))
    rec = MOE.Routing()
    y, aux = MOE.apply_moe(tcfg, tp, x, None, routing=rec)
    MOE.apply_moe(tcfg, tp, other, None, routing=rec)
    assert len(rec.choices) == 2 and rec.calls == 2
    pinned = rec.pinned()
    y2, aux2 = MOE.apply_moe(tcfg, tp, x, None, routing=pinned)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    # the second recorded call is other's: x on other's choices differs
    y3, _ = MOE.apply_moe(tcfg, tp, x, None, routing=pinned)
    assert not torch.equal(y, y3)
    with pytest.raises(IndexError, match="no recorded choices"):
        MOE.apply_moe(tcfg, tp, x, None, routing=pinned)


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

def ssd_inputs(seed, b=2, s=16, h=3, p=8, n=4):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    dt = np.log1p(np.exp(r(b, s, h))).astype(np.float32)   # softplus
    return r(b, s, h, p), dt, r(h) * np.float32(0.1), r(b, s, n), \
        r(b, s, n), r(b, h, p, n)


def step_ssd(xh, dt, a_log, bb, cc, state):
    """The explicit per-step recurrence, in numpy float64."""
    a = -np.exp(a_log.astype(np.float64))
    state = state.astype(np.float64)
    ys = []
    for t in range(xh.shape[1]):
        decay = np.exp(dt[:, t] * a)
        upd = np.einsum("bh,bhp,bn->bhpn", dt[:, t], xh[:, t], bb[:, t])
        state = state * decay[..., None, None] + upd
        ys.append(np.einsum("bn,bhpn->bhp", cc[:, t], state))
    return np.stack(ys, axis=1), state


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s,chunk", [(16, 5), (16, 16), (7, 4), (1, 4)])
def test_ssd_chunked_matches_jax_and_the_recurrence(s, chunk, with_state):
    xh, dt, a_log, bb, cc, st = ssd_inputs(s * 10 + chunk, s=s)
    init = st if with_state else None
    jy, jfinal = JSSM.ssd_chunked(
        jnp.asarray(xh), jnp.asarray(dt), jnp.asarray(a_log),
        jnp.asarray(bb), jnp.asarray(cc), chunk,
        None if init is None else jnp.asarray(init))
    ty, tfinal = SSM.ssd_chunked(
        *(torch.from_numpy(a) for a in (xh, dt, a_log, bb, cc)), chunk,
        None if init is None else torch.from_numpy(init))
    assert ty.dtype == tfinal.dtype == F32
    assert tuple(ty.shape) == xh.shape
    close(ty, jy)
    close(tfinal, jfinal)
    want_y, want_state = step_ssd(xh, dt, a_log, bb, cc,
                                  np.zeros_like(st) if init is None
                                  else init)
    close(ty, want_y, atol=1e-4, rtol=1e-4)
    close(tfinal, want_state, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("group", [1, 2])
def test_ssd_chunked_in_groups_of_chunks(group, with_state, monkeypatch):
    """Chunks taken ``group`` at a time (``SSD_GROUP_BYTES`` cut to that
    many chunks' (B, L, L, H) float32 terms): 5 chunks of 4 with a ragged
    tail, the state carried across the groups, against the JAX function,
    the float64 recurrence and the call that takes all chunks at once."""
    s, chunk = 18, 4
    xh, dt, a_log, bb, cc, st = ssd_inputs(7 + group, s=s)
    init = st if with_state else None
    args = [torch.from_numpy(a) for a in (xh, dt, a_log, bb, cc)]
    t_init = None if init is None else torch.from_numpy(init)
    whole_y, whole_final = SSM.ssd_chunked(*args, chunk, t_init)
    b, h = xh.shape[0], xh.shape[2]
    monkeypatch.setattr(SSM, "SSD_GROUP_BYTES",
                        group * 4 * b * chunk * chunk * h)
    sizes = []
    inner = SSM._ssd_group

    def counted(xh_, *a):
        sizes.append(xh_.shape[1] // chunk)
        return inner(xh_, *a)
    monkeypatch.setattr(SSM, "_ssd_group", counted)
    ty, tfinal = SSM.ssd_chunked(*args, chunk, t_init)
    assert sizes == [group] * (5 // group) + [5 % group] * (5 % group > 0)
    assert tuple(ty.shape) == xh.shape
    close(ty, whole_y, atol=1e-6, rtol=1e-6)
    close(tfinal, whole_final, atol=1e-6, rtol=1e-6)
    jy, jfinal = JSSM.ssd_chunked(
        *(jnp.asarray(a) for a in (xh, dt, a_log, bb, cc)), chunk,
        None if init is None else jnp.asarray(init))
    close(ty, jy)
    close(tfinal, jfinal)
    want_y, want_state = step_ssd(xh, dt, a_log, bb, cc,
                                  np.zeros_like(st) if init is None
                                  else init)
    close(ty, want_y, atol=1e-4, rtol=1e-4)
    close(tfinal, want_state, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dt_scale", [1.0, 4.0])
def test_ssd_gradients_stay_finite_past_exps_range(dt_scale):
    """A chunk of 256 steps whose decay sums pass float32's exp range
    above the diagonal (cum_i - cum_j up to ~180 at dt ~ 0.7, as mamba2
    at full size reaches): the port's gradients are finite and equal a
    float64 step loop's; the JAX package's ``jnp.where(causal,
    jnp.exp(diff), 0)`` gives NaN there (0 * inf in exp's backward).
    The forward is the same in both (1e-4, the SSD scan's limit).  The
    gradients are float32 against float64 over one 256-step chunk: 2e-6
    (x, B, C) to 2.2e-4 (a_log, summed over the whole chunk, at 4x the
    init's dt), so 1e-3."""
    xh, dt, a_log, bb, cc, _ = ssd_inputs(5, b=1, s=256, h=2, p=4, n=4)
    dt = dt * np.float32(dt_scale)
    a_log = np.zeros_like(a_log)
    t = [torch.from_numpy(a).double().requires_grad_()
         for a in (xh, dt, a_log, bb, cc)]
    y, _ = SSM.ssd_chunked(*(x.float() for x in t[:5]), 256)
    gy = torch.from_numpy(np.random.default_rng(6).standard_normal(
        y.shape).astype(np.float32))
    got = torch.autograd.grad(y, t, gy)

    def loop(xh, dt, a_log, bb, cc):
        a = -torch.exp(a_log)
        state = torch.zeros(xh.shape[0], xh.shape[2], xh.shape[3],
                            bb.shape[-1], dtype=torch.float64)
        ys = []
        for i in range(xh.shape[1]):
            state = state * torch.exp(dt[:, i] * a)[..., None, None] + \
                torch.einsum("bh,bhp,bn->bhpn", dt[:, i], xh[:, i], bb[:, i])
            ys.append(torch.einsum("bn,bhpn->bhp", cc[:, i], state))
        return torch.stack(ys, 1)
    want = torch.autograd.grad(loop(*t), t, gy.double())
    for name, g, w in zip(("xh", "dt", "a_log", "bb", "cc"), got, want):
        assert bool(torch.isfinite(g).all()), name
        rel = float((g - w).norm() / w.norm())
        assert rel < 1e-3, (name, rel)

    def jloss(*args):
        y, _ = JSSM.ssd_chunked(*args, 256)
        return jnp.sum(y * jnp.asarray(gy.numpy()))
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (xh, dt, a_log, bb, cc)))
    assert not all(np.isfinite(np.asarray(g)).all() for g in jg)
    jy, _ = JSSM.ssd_chunked(*(jnp.asarray(a) for a in
                               (xh, dt, a_log, bb, cc)), 256)
    close(y.detach(), jy, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    x, w = randn(1, 2, 9, 6), randn(2, 4, 6)
    state = randn(3, 2, 3, 6) if with_state else None
    jy, jst = JSSM._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                None if state is None else jnp.asarray(state))
    ty, tst = SSM._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                               None if state is None
                               else torch.from_numpy(state))
    close(ty, jy, atol=1e-6, rtol=1e-6)
    close(tst, jst, atol=0, rtol=0)


def test_gated_rmsnorm_matches_jax():
    scale, x, z = randn(1, 12), randn(2, 2, 5, 12), randn(3, 2, 5, 12)
    want = JSSM._gated_rmsnorm(jnp.asarray(scale), jnp.asarray(x),
                               jnp.asarray(z))
    got = SSM._gated_rmsnorm(torch.from_numpy(scale), torch.from_numpy(x),
                             torch.from_numpy(z))
    close(got, want, atol=1e-6, rtol=1e-6)


def _state_trees(jstate, tstate):
    for key, want in jstate.items():
        close(tstate[key], want)


def test_apply_ssm_prefill_then_decode_matches_jax():
    """A prefill into a zero state (the chunked branch with its initial
    state), then three single-step decodes; the state is updated in
    place and equals the JAX state after each call."""
    jcfg, tcfg = cfgs(d_model=16, ssm_expand=2)
    jp, tp = both_trees(params(JSSM.ssm_defs(jcfg)))
    u = randn(4, 2, 9, 16)
    jst = jax.tree_util.tree_map(lambda a: a[0],
                                 JSSM.init_ssm_state(jcfg, 1, 2))
    tst = {k: v[0] for k, v in SSM.init_ssm_state(tcfg, 1, 2,
                                                  device="cpu").items()}
    keep = {k: v for k, v in tst.items()}
    jy, jst = JSSM.apply_ssm(jcfg, jp, jnp.asarray(u[:, :6]), None,
                             state=jst, chunk=4)
    ty, tst = SSM.apply_ssm(tcfg, tp, torch.from_numpy(u[:, :6]), None,
                            state=tst, chunk=4)
    assert all(tst[k] is keep[k] for k in keep)        # in place
    close(ty, jy)
    _state_trees(jst, tst)
    for i in range(6, 9):
        jy, jst = JSSM.apply_ssm(jcfg, jp, jnp.asarray(u[:, i:i + 1]),
                                 None, state=jst)
        ty, tst = SSM.apply_ssm(tcfg, tp, torch.from_numpy(u[:, i:i + 1]),
                                None, state=tst)
        close(ty, jy)
        _state_trees(jst, tst)
    # without a state: the training path
    jy, none = JSSM.apply_ssm(jcfg, jp, jnp.asarray(u), None, chunk=4)
    ty, tnone = SSM.apply_ssm(tcfg, tp, torch.from_numpy(u), None, chunk=4)
    assert none is None and tnone is None
    close(ty, jy)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def loop_scan(x, a, h0):
    h = np.zeros(x[:, 0].shape, np.float64) if h0 is None \
        else h0.astype(np.float64)
    out = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + x[:, t]
        out.append(h)
    return np.stack(out, 1), h


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 2, 7, 12, 33])
def test_rglru_scan_matches_jax_and_a_loop(s, with_h0):
    x = randn(s, 2, s, 8)
    a = 1 / (1 + np.exp(-randn(s + 1, 2, s, 8)))
    h0 = randn(s + 2, 2, 8) if with_h0 else None
    jh, jlast = JRG._rglru_scan(jnp.asarray(x), jnp.asarray(a),
                                None if h0 is None else jnp.asarray(h0))
    th, tlast = RG._rglru_scan(torch.from_numpy(x), torch.from_numpy(a),
                               None if h0 is None else torch.from_numpy(h0))
    close(th, jh, atol=1e-5, rtol=1e-5)
    close(tlast, jlast, atol=1e-5, rtol=1e-5)
    want, want_last = loop_scan(x, a, h0)
    close(th, want, atol=1e-5, rtol=1e-5)
    close(tlast, want_last, atol=1e-5, rtol=1e-5)


def test_rglru_scan_launches_log_depth():
    """ceil(log2 S) doubling rounds, not S steps: 2048 positions take
    11 rounds of 4 whole-tensor ops."""
    calls = []
    real = torch.cat

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    torch.cat = counting
    try:
        RG._rglru_scan(torch.rand(1, 2048, 2), torch.rand(1, 2048, 2), None)
    finally:
        torch.cat = real
    assert len(calls) == 2 * 11


def test_apply_rglru_prefill_then_decode_matches_jax():
    jcfg, tcfg = cfgs(d_model=16, rnn_width=24, act="gelu")
    jp, tp = both_trees(params(JRG.rglru_defs(jcfg)))
    u = randn(5, 2, 10, 16)
    jst = jax.tree_util.tree_map(lambda a: a[0],
                                 JRG.init_rglru_state(jcfg, 1, 2))
    tst = {k: v[0] for k, v in RG.init_rglru_state(tcfg, 1, 2,
                                                   device="cpu").items()}
    keep = dict(tst)
    jy, jst = JRG.apply_rglru(jcfg, jp, jnp.asarray(u[:, :7]), None,
                              state=jst)
    ty, tst = RG.apply_rglru(tcfg, tp, torch.from_numpy(u[:, :7]), None,
                             state=tst)
    assert all(tst[k] is keep[k] for k in keep)
    close(ty, jy)
    _state_trees(jst, tst)
    for i in range(7, 10):
        jy, jst = JRG.apply_rglru(jcfg, jp, jnp.asarray(u[:, i:i + 1]),
                                  None, state=jst)
        ty, tst = RG.apply_rglru(tcfg, tp, torch.from_numpy(u[:, i:i + 1]),
                                 None, state=tst)
        close(ty, jy)
        _state_trees(jst, tst)
    jy, _ = JRG.apply_rglru(jcfg, jp, jnp.asarray(u), None)
    ty, _ = RG.apply_rglru(tcfg, tp, torch.from_numpy(u), None)
    close(ty, jy)


class Counting:
    """The plain versions, each call's operand types recorded."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        fn = getattr(F.PLAIN, name)

        def call(*args, **kwargs):
            self.calls.append((name, tuple(a.dtype for a in args
                                           if isinstance(a, torch.Tensor))))
            return fn(*args, **kwargs)
        return call


def test_mixer_products_go_through_impl():
    """In a bfloat16 model: mamba2's two projections and RG-LRU's five
    through ``impl.matmul``, RG-LRU's ``r`` and ``i`` in float32 (the
    reference's upcast), the rest in bfloat16."""
    bf = torch.bfloat16
    jcfg, tcfg = cfgs()
    tcfg = tcfg.replace(dtype=bf)
    counting = Counting()
    u = torch.randn(1, 5, 16).to(bf)
    p = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a).to(bf), params(JSSM.ssm_defs(jcfg)))
    SSM.apply_ssm(tcfg, p, u, None, impl=counting)
    assert counting.calls == [("matmul", (bf, bf))] * 2
    counting.calls.clear()
    p = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a).to(bf), params(JRG.rglru_defs(jcfg)))
    RG.apply_rglru(tcfg, p, u, None, impl=counting)
    f32 = (F32, F32)
    assert counting.calls == [("matmul", (bf, bf))] * 2 + \
        [("matmul", f32)] * 2 + [("matmul", (bf, bf))]

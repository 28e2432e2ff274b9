"""The port's ``models.transformer.Model`` against the JAX package's, on
all ten configurations at ``reduced(...)`` size in float32 (attention,
Mamba2 and RG-LRU mixers, dense and MoE FFNs), from the same weights
(numpy, seeded, carried by ``interop.params_from_numpy``).

* ``forward`` logits equal the JAX ``forward``'s within 2e-4 (llama4:
  5e-4, below), and its MoE aux loss the JAX aux within 1e-6 relative;
* prefill + decode equal the port's own full forward within 5e-3, as
  ``tests/test_decode.py`` holds the JAX model (at ``moe_capacity=8.0``,
  its no-drop capacity, as there: at 1.25 a prefill drops tokens a
  decode step keeps), and the JAX prefill and decode within 2e-4 (llama4:
  5e-4);
* the cache after a prefill (KV buffers, SSD and RG-LRU states, conv
  tails) equals the JAX cache;
* a staged prefill on the chunked path equals the dense path; a window
  that covers the sequence equals full attention; an int8 cache tracks
  the float32 one;
* parameter trees and counts equal the JAX ``param_defs``; a mixer the
  JAX package does not know raises ``ValueError``.

On the CPU the kernel entry points run their plain versions; the JAX
model is plain jnp (no Pallas kernel on its path).  The models without
q/k norm are badly conditioned at the reference's init (``wq`` has std
1/sqrt(n_heads)): the JAX model against itself with its weights moved by
1e-7 relative noise reads 1.1e-4 (pixtral), 3.3e-4 (whisper) and
5.4-6.6e-4 (llama4, three draws of ``tests/jax_noise_floor.py``) in
the logits, so 2e-4 is about float32's own floor there; llama4, which
reads 2.1e-4 from the JAX model, is held at 5e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models.common import ParamDef as JParamDef  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models.common import TensorSpec  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

ARCHS = ["qwen3-0.6b", "smollm-360m", "stablelm-1.6b", "gemma3-27b",
              "pixtral-12b", "whisper-tiny", "mamba2-130m",
              "recurrentgemma-9b", "granite-moe-1b-a400m",
              "llama4-maverick-400b-a17b"]
B, S, PRE = 2, 24, 16
F32 = torch.float32
# the logit limit against the JAX model: float32's floor at this init
# (module docstring)
LOGITS_ABS = {"llama4-maverick-400b-a17b": 5e-4}
# decode equality needs a capacity that drops nothing (tests/test_decode.py)
NO_DROP = dict(moe_capacity=8.0)


def configs(arch, **kw):
    """The reduced float32 configuration in both packages."""
    jcfg = jreduced(jget_config(arch)).replace(dtype=jnp.float32,
                                               remat=False, **kw)
    tcfg = reduced(get_config(arch)).replace(dtype=F32, remat=False, **kw)
    return jcfg, tcfg


def numpy_params(jcfg, seed=0):
    """Seeded float32 weights for the JAX model's parameter tree: each
    normal leaf at its init's std, norm scales 1 + 0.1 N(0, 1) and biases
    0.1 N(0, 1) (so that neither is a no-op)."""
    rng = np.random.default_rng(seed)
    defs = JModel(jcfg).param_defs()

    def leaf(d):
        z = rng.standard_normal(d.shape).astype(np.float32)
        if d.init == "ones":
            return np.float32(1) + np.float32(0.1) * z
        if d.init == "zeros":
            return np.float32(0.1) * z
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        return z * np.float32(d.scale / np.sqrt(max(1, fan_in)))
    return jax.tree_util.tree_map(leaf, defs,
                                  is_leaf=lambda x: isinstance(x, JParamDef))


def inputs(cfg, seq=S, seed=1):
    """Tokens (B, seq) and the stubbed frontend inputs, from numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, seq),
                                  dtype=np.int32)}
    if cfg.encoder_layers:
        out["frames"] = (rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.n_patches:
        out["patches"] = (rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def both(arch, **kw):
    jcfg, tcfg = configs(arch, **kw)
    p = numpy_params(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, p)
    return (JModel(jcfg), jparams), (Model(tcfg), params_from_numpy(p,
                                                                    "cpu"))


def kernel_calls(cfg, prefill: bool) -> dict:
    """Kernel calls of one prefill (``prefill``) or decode step of
    ``Model(cfg)``, by kernel, reckoned from the configuration: per
    layer, attention 4 GEMMs (q, k, v, o) and in a prefill one flash
    attention; mamba2 2 (in, out); RG-LRU 5 (x, gate, r, i, out); a
    dense FFN 3; a MoE FFN the router and 3 an expert (and 3 for a
    shared expert); then the LM head.  RMSNorm configs: norm1, norm2
    (with an FFN) a layer and the final norm, each one fused add+norm."""
    gemms = {"attn": 4, "mamba2": 2, "rglru": 5}
    matmul = flash = norms = 0
    for entry in cfg.layer_kinds():
        kind = entry.split("+")[0]
        matmul += gemms[kind]
        flash += kind == "attn" and prefill
        norms += 1
        if cfg.d_ff > 0:
            norms += 1
            matmul += 1 + 3 * cfg.n_experts + 3 * cfg.shared_expert \
                if entry.endswith("+moe") else 3
    return {"matmul": matmul + 1, "flash_attention": flash,
            "fused_add_rmsnorm": norms + 1
            if cfg.norm_type == "rmsnorm" else 0}


def jx(arrs):
    return {k: jnp.asarray(v) for k, v in arrs.items()}


def tx(arrs):
    return {k: torch.from_numpy(v) for k, v in arrs.items()}


def maxdiff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    (jm, jp), (tm, tp) = both(arch)
    data = inputs(jm.cfg)
    j = jx(data)
    want, _, jaux = jm.forward(jp, j["tokens"], frames=j.get("frames"),
                               patches=j.get("patches"))
    t = tx(data)
    got, cache, aux = tm.forward(tp, t["tokens"], frames=t.get("frames"),
                                 patches=t.get("patches"))
    assert cache is None and aux.dtype == F32 and aux.shape == ()
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    assert (float(aux) > 0) == (tm.cfg.n_experts > 0)
    assert got.dtype == F32 and tuple(got.shape) == tuple(want.shape)
    assert maxdiff(got, want) < LOGITS_ABS.get(arch, 2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward_and_jax(arch):
    (jm, jp), (tm, tp) = both(arch, **NO_DROP)
    data = inputs(jm.cfg)
    t, j = tx(data), jx(data)
    fr = {k: t[k] for k in ("frames", "patches") if k in t}
    logits, _, _ = tm.forward(tp, t["tokens"], **fr)
    if "patches" in t:
        logits = logits[:, t["patches"].shape[1]:]

    last, cache = tm.prefill(tp, t["tokens"][:, :PRE], max_len=S + 8, **fr)
    jfr = {k: j[k] for k in ("frames", "patches") if k in j}
    jlast, jcache = jm.prefill(jp, j["tokens"][:, :PRE], max_len=S + 8,
                               **jfr)
    jdecode = jax.jit(jm.decode_step)
    errs = [maxdiff(last, logits[:, PRE - 1])]
    jerrs = [maxdiff(last, jlast)]
    for i in range(PRE, S):
        lg, cache = tm.decode_step(tp, t["tokens"][:, i:i + 1], cache)
        jlg, jcache = jdecode(jp, j["tokens"][:, i:i + 1], jcache)
        errs.append(maxdiff(lg, logits[:, i]))
        jerrs.append(maxdiff(lg, jlg))
    assert max(errs) < 5e-3, f"{arch}: max err {max(errs)}"
    assert max(jerrs) < LOGITS_ABS.get(arch, 2e-4), \
        f"{arch}: max err against JAX {max(jerrs)}"


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_cache_after_prefill_matches_jax(arch):
    (jm, jp), (tm, tp) = both(arch, **NO_DROP)
    data = inputs(jm.cfg, seq=PRE)
    t, j = tx(data), jx(data)
    _, cache = tm.prefill(tp, t["tokens"], max_len=S + 8,
                          **{k: t[k] for k in ("frames", "patches")
                             if k in t})
    _, jcache = jm.prefill(jp, j["tokens"], max_len=S + 8,
                           **{k: j[k] for k in ("frames", "patches")
                              if k in j})
    got, want = dict(_leaves(cache)), dict(_leaves(jcache))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == tuple(w.shape), name
        if "pos" in name:
            assert g.dtype == torch.int32, name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
        else:
            # GEMMs in another order, through up to three layers (whisper's
            # keys reach 18 in magnitude): relative to the leaf's scale
            scale = max(1.0, float(np.abs(np.asarray(w)).max()))
            assert maxdiff(g, w) < 5e-5 * scale, name


def test_staged_prefill_chunked_equals_dense():
    """A second prefill chunk (position > 0) runs the chunked path when
    it is longer than ``dense_attn_max_seq``, the dense path otherwise;
    the two agree, and the chunked function agrees with the JAX one."""
    _, tcfg = configs("qwen3-0.6b")
    jcfg, _ = configs("qwen3-0.6b")
    tp = params_from_numpy(numpy_params(jcfg), "cpu")
    tokens = torch.from_numpy(inputs(tcfg, seq=48)["tokens"])
    outs = []
    for cfg in (tcfg, tcfg.replace(dense_attn_max_seq=1, attn_block=16)):
        m = Model(cfg)
        _, cache = m.prefill(tp, tokens[:, :16], max_len=56)
        with torch.inference_mode():
            logits, cache, _ = m.forward(tp, tokens[:, 16:], cache=cache)
        assert int(cache["blk0"]["pos"][0]) == 48
        outs.append(logits)
    assert maxdiff(outs[0], outs[1]) < 2e-4


def test_chunked_model_matches_jax_chunked():
    """The JAX model on its chunked path (its forward, past
    ``dense_attn_max_seq``) against the port's forward (flash path)."""
    kw = dict(dense_attn_max_seq=1, attn_block=16)
    (jm, jp), (tm, tp) = both("qwen3-0.6b", **kw)
    data = inputs(jm.cfg, seq=48)
    want, _, _ = jm.forward(jp, jnp.asarray(data["tokens"]))
    got, _, _ = tm.forward(tp, torch.from_numpy(data["tokens"]))
    assert maxdiff(got, want) < 2e-4


def test_windowed_equals_full_when_window_covers():
    jcfg, base = configs("smollm-360m")
    tp = params_from_numpy(numpy_params(jcfg), "cpu")
    tokens = torch.from_numpy(inputs(base, seq=16)["tokens"])
    full, _, _ = Model(base).forward(tp, tokens)
    wide = Model(base.replace(window=64, attn_pattern=("local",)))
    wfull, _, _ = wide.forward(tp, tokens)
    assert maxdiff(full, wfull) < 1e-5
    narrow = Model(base.replace(window=4, attn_pattern=("local",)))
    nout, _, _ = narrow.forward(tp, tokens)
    assert maxdiff(full, nout) > 1e-4   # must differ


def test_int8_kv_cache_close_to_f32():
    """Quantized KV serving tracks the float32 cache within quantization
    error, as in ``tests/test_decode.py``, and stores what the JAX int8
    cache stores."""
    (jm, jp), (tm, tp) = both("qwen3-0.6b")
    data = inputs(tm.cfg)
    tokens = torch.from_numpy(data["tokens"])
    last, cache = tm.prefill(tp, tokens[:, :PRE], max_len=S + 8)
    m8 = Model(tm.cfg.replace(cache_dtype=torch.int8))
    last8, cache8 = m8.prefill(tp, tokens[:, :PRE], max_len=S + 8)
    assert cache8["blk0"]["k"].dtype == torch.int8
    jm8 = JModel(jm.cfg.replace(cache_dtype=jnp.int8))
    _, jcache8 = jm8.prefill(jp, jnp.asarray(data["tokens"][:, :PRE]),
                             max_len=S + 8)
    for name in ("k", "v"):
        # one quantization step at most, where a value sits on a rounding
        # boundary within float32 noise
        diff = np.abs(cache8["blk0"][name].numpy().astype(np.int32)
                      - np.asarray(jcache8["blk0"][name], np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, name
        assert maxdiff(cache8["blk0"][f"{name}_scale"],
                       jcache8["blk0"][f"{name}_scale"]) < 1e-6
    agree = [int((last.argmax(-1) == last8.argmax(-1)).sum())]
    for i in range(PRE, PRE + 4):
        lg, cache = tm.decode_step(tp, tokens[:, i:i + 1], cache)
        lg8, cache8 = m8.decode_step(tp, tokens[:, i:i + 1], cache8)
        agree.append(int((lg.argmax(-1) == lg8.argmax(-1)).sum()))
    assert sum(agree) >= int(0.8 * B * len(agree))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_and_count_match_jax(arch):
    jcfg, tcfg = configs(arch)
    jdefs = JModel(jcfg).param_defs()
    want = {name: tuple(d.shape) for name, d in _leaves(jax.tree_util.
            tree_map(lambda d: d, jdefs,
                     is_leaf=lambda x: isinstance(x, JParamDef)))}
    model = Model(tcfg)
    got = {name: tuple(d.shape) for name, d in _leaves(model.param_defs())}
    assert got == want
    count = sum(int(np.prod(s)) for s in want.values())
    assert model.n_params() == count
    spec = dict(_leaves(model.abstract()))
    assert all(isinstance(s, TensorSpec) and s.dtype == F32
               for s in spec.values())
    params = model.init(torch.Generator().manual_seed(0))
    assert {n: tuple(t.shape) for n, t in _leaves(params)} == want
    assert all(t.dtype == F32 for _, t in _leaves(params))


def test_full_size_qwen3_param_count():
    """Qwen3-0.6B's declared parameters, in both packages (no arrays)."""
    from repro.models.common import abstract_params
    jm = JModel(jget_config("qwen3-0.6b"))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(
        abstract_params(jm.param_defs())))
    assert Model(get_config("qwen3-0.6b")).n_params() == want == 596049920


def test_unknown_mixer_raises():
    cfg = reduced(get_config("qwen3-0.6b"))
    for pattern in (("lstm",), ("attn", "mamba3+moe")):
        with pytest.raises(ValueError):
            Model(cfg.replace(block_pattern=pattern))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "llama4-maverick-400b-a17b"])
def test_own_routing_changes_nothing(arch):
    """A model fed the MoE choices it recorded (``moe.Routing``) gives
    the same bits, through a forward and through prefill + decode."""
    from repro_torch.models.moe import Routing
    _, (tm, tp) = both(arch)
    tokens = torch.from_numpy(inputs(tm.cfg)["tokens"])
    rec = Routing()
    want, _, aux = tm.forward(tp, tokens, routing=rec)
    got, _, aux2 = tm.forward(tp, tokens, routing=rec.pinned())
    assert torch.equal(got, want) and torch.equal(aux, aux2)
    rec = Routing()
    last, cache = tm.prefill(tp, tokens[:, :PRE], max_len=S + 8,
                             routing=rec)
    steps = [tm.decode_step(tp, tokens[:, i:i + 1], cache, routing=rec)[0]
             for i in range(PRE, S)]
    pinned = rec.pinned()
    plast, pcache = tm.prefill(tp, tokens[:, :PRE], max_len=S + 8,
                               routing=pinned)
    assert torch.equal(plast, last)
    for i, want in zip(range(PRE, S), steps):
        got, pcache = tm.decode_step(tp, tokens[:, i:i + 1], pcache,
                                     routing=pinned)
        assert torch.equal(got, want)
    assert pinned.calls == len(rec.choices) == \
        (S - PRE + 1) * sum(e.endswith("+moe") for e in tm.cfg.layer_kinds())


def test_rules_other_than_none_raise():
    """Rules are accepted since the sharding slice: on plain tensors,
    ``PROD_RULES`` alone and sized to a (1, 1) mesh give the unruled
    logits bit for bit.  (The name dates from when rules raised; it is
    kept so that the test's record runs on.)"""
    from types import SimpleNamespace
    from repro_torch.models.common import PROD_RULES, with_axis_sizes
    _, tcfg = configs("qwen3-0.6b")
    model = Model(tcfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    want = model.forward(params, tokens)[0]
    sized = with_axis_sizes(PROD_RULES, SimpleNamespace(
        mesh_dim_names=("data", "model"), shape=(1, 1)))
    for rules in (PROD_RULES, {"batch": "data"}, sized):
        assert torch.equal(model.forward(params, tokens, rules=rules)[0],
                           want)

"""The port's model layers (``repro_torch.models.{common,layers,attention,
frontends}``) against the JAX package's, function by function, on the
same numpy inputs in float32: within 1e-5, and within 2e-4 where a
product's sum runs in another order (the projections, and attention's
contractions over head_dim and keys).  Plus the parameter declaration
(``init_params``), the tree bridge ``interop.params_from_numpy`` and the
frontend stubs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import attention as JATT  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.common import ModelConfig as JConfig  # noqa: E402
from repro.models.frontends import frontend_input_specs as jspecs  # noqa
from repro_torch.interop import params_from_numpy, to_numpy  # noqa: E402
from repro_torch.kernels import forward as F  # noqa: E402
from repro_torch.models import attention as ATT  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.common import (ModelConfig, ParamDef,  # noqa: E402
                                       TensorSpec, abstract_params,
                                       init_params, param_count)
from repro_torch.models.frontends import (  # noqa: E402
    frontend_input_specs, synth_frontend_inputs)

KW = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
          n_kv_heads=2, d_ff=64, vocab_size=101, head_dim=16)


def cfgs(**kw):
    return (JConfig(**KW, dtype=jnp.float32, **kw),
            ModelConfig(**KW, dtype=torch.float32, **kw))


def rn(rng, *shape, std=1.0):
    return (rng.standard_normal(shape) * std).astype(np.float32)


def close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=tol)


# ---- layers ---------------------------------------------------------------

@pytest.mark.parametrize("fraction", [1.0, 0.25, 0.0])
def test_rope_matches_jax(fraction):
    rng = np.random.default_rng(0)
    x = rn(rng, 2, 40, 4, 16)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40)) + 7
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e4, fraction)
    got = L.rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), 1e4,
                 fraction)
    close(got, want, 1e-5)
    if fraction == 0.0:
        np.testing.assert_array_equal(got.numpy(), x)


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_jax(norm_type):
    jcfg, tcfg = cfgs(norm_type=norm_type)
    rng = np.random.default_rng(1)
    x = rn(rng, 2, 5, 32, std=3.0)
    p = {"scale": 1 + rn(rng, 32, std=0.1), "bias": rn(rng, 32, std=0.1)}
    if norm_type == "rmsnorm":
        del p["bias"]
    want = JL.apply_norm(jcfg, jax.tree_util.tree_map(jnp.asarray, p),
                         jnp.asarray(x))
    got = L.apply_norm(tcfg, params_from_numpy(p, "cpu"),
                       torch.from_numpy(x))
    close(got, want, 1e-5)


def test_rms_head_norm_matches_jax():
    rng = np.random.default_rng(2)
    x, s = rn(rng, 2, 6, 4, 16, std=2.0), 1 + rn(rng, 16, std=0.1)
    close(L.rms_head_norm(torch.from_numpy(s), torch.from_numpy(x)),
          JL.rms_head_norm(jnp.asarray(s), jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_act_matches_jax(act):
    """``jax.nn.gelu`` is the tanh approximation, as the port's."""
    jcfg, tcfg = cfgs(act=act)
    x = np.linspace(-8, 8, 1001, dtype=np.float32)
    close(L._act(tcfg, torch.from_numpy(x)), JL._act(jcfg, jnp.asarray(x)),
          1e-5)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_apply_mlp_matches_jax(act):
    jcfg, tcfg = cfgs(act=act)
    rng = np.random.default_rng(3)
    p = {"wi": rn(rng, 32, 64, std=0.2), "wg": rn(rng, 32, 64, std=0.2),
         "wo": rn(rng, 64, 32, std=0.1)}
    x = rn(rng, 2, 7, 32)
    want = JL.apply_mlp(jcfg, jax.tree_util.tree_map(jnp.asarray, p),
                        jnp.asarray(x), None)
    calls = _Counting()
    got = L.apply_mlp(tcfg, params_from_numpy(p, "cpu"),
                      torch.from_numpy(x), None, impl=calls)
    close(got, want, 2e-4)
    assert calls.n["matmul"] == 3


def test_embed_and_lm_logits_match_jax():
    rng = np.random.default_rng(4)
    emb, head = rn(rng, 101, 32), rn(rng, 32, 101)
    tokens = rng.integers(0, 101, (2, 5), dtype=np.int32)
    x = L.embed_tokens({"embedding": torch.from_numpy(emb)},
                       torch.from_numpy(tokens), None, torch.float32)
    close(x, JL.embed_tokens({"embedding": jnp.asarray(emb)},
                             jnp.asarray(tokens), None, jnp.float32), 0)
    for p in ({"embedding": emb}, {"embedding": emb, "head": head}):
        want = JL.lm_logits(jax.tree_util.tree_map(jnp.asarray, p),
                            jnp.asarray(to_numpy(x)), None)
        got = L.lm_logits(params_from_numpy(p, "cpu"), x, None)
        assert got.dtype == torch.float32
        close(got, want, 2e-4)


# ---- attention --------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 3])
def test_mask_bias_matches_jax(causal, window):
    q_pos = np.arange(5, 11, dtype=np.int32)
    k_pos = np.where(np.arange(14) < 11, np.arange(14), -10 ** 9)
    want = np.asarray(JATT._mask_bias(jnp.asarray(q_pos), jnp.asarray(k_pos),
                                      causal, window))
    for w in (window, torch.tensor(window)):
        got = ATT._mask_bias(torch.from_numpy(q_pos),
                             torch.from_numpy(k_pos), causal, w)
        np.testing.assert_array_equal(got.numpy(), want)


def _qkv(rng, b=2, s=6, t=9, h=4, kv=2, d=16):
    return rn(rng, b, s, h, d), rn(rng, b, t, kv, d), rn(rng, b, t, kv, d)


def test_dense_attention_matches_jax():
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng)
    bias = np.array(JATT._mask_bias(jnp.arange(3, 9), jnp.arange(9), True,
                                    4))
    want = JATT._dense_attention(*map(jnp.asarray, (q, k, v, bias)))
    got = ATT._dense_attention(*map(torch.from_numpy, (q, k, v, bias)))
    close(got, want, 2e-4)


@pytest.mark.parametrize("window", [0, 5])
def test_chunked_attention_matches_jax(window):
    """Block 4 over 11 keys: one padded block, and rows of a window."""
    rng = np.random.default_rng(6)
    q, k, v = _qkv(rng, s=7, t=11)
    q_pos = np.arange(4, 11)
    k_pos = np.where(np.arange(11) < 10, np.arange(11), -10 ** 9)
    want = JATT._chunked_attention_dynwin(
        *map(jnp.asarray, (q, k, v, q_pos, k_pos)), True,
        jnp.asarray(window), 4)
    got = ATT._chunked_attention_dynwin(
        *map(torch.from_numpy, (q, k, v, q_pos, k_pos)), True,
        torch.tensor(window), 4)
    close(got, want, 2e-4)
    bias = ATT._mask_bias(torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                          True, window)
    close(got, ATT._dense_attention(*map(torch.from_numpy, (q, k, v)), bias),
          2e-4)


class _Counting:
    """An ``impl`` that runs the plain versions and counts calls."""

    def __init__(self):
        self.n = {"matmul": 0, "fused_add_rmsnorm": 0, "flash_attention": 0}

    def __getattr__(self, name):
        fn = getattr(F.PLAIN, name)

        def call(*args, **kwargs):
            self.n[name] += 1
            return fn(*args, **kwargs)
        return call


def _attn_params(rng, qk_norm=True, d=32, h=4, kv=2, hd=16):
    p = {"wq": rn(rng, d, h, hd, std=0.2), "wk": rn(rng, d, kv, hd, std=0.2),
         "wv": rn(rng, d, kv, hd, std=0.2), "wo": rn(rng, h, hd, d, std=0.1)}
    if qk_norm:
        p["q_norm"] = 1 + rn(rng, hd, std=0.1)
        p["k_norm"] = 1 + rn(rng, hd, std=0.1)
    return p


def _cache(b, t, dtype, pos, rng=None):
    kv = {"k": np.zeros((b, t, 2, 16), dtype),
          "v": np.zeros((b, t, 2, 16), dtype),
          "pos": np.asarray(pos, np.int32)}
    if dtype == np.int8:
        kv["k_scale"] = np.zeros((b, t, 2), np.float32)
        kv["v_scale"] = np.zeros((b, t, 2), np.float32)
    if rng is not None and pos:      # earlier tokens already written
        for name in ("k", "v"):
            if dtype == np.int8:
                kv[name][:, :pos] = rng.integers(-127, 128, (b, pos, 2, 16))
                kv[f"{name}_scale"][:, :pos] = rng.uniform(
                    0.001, 0.02, (b, pos, 2)).astype(np.float32)
            else:
                kv[name][:, :pos] = rn(rng, b, pos, 2, 16)
    return kv


@pytest.mark.parametrize("case", [
    "no_cache", "no_cache_window", "cache_pos0", "staged", "decode",
    "int8_pos0", "int8_decode", "cross"])
def test_attention_matches_jax(case):
    """``attention`` with and without a cache (the flash path at position
    0, the dense path for a staged prefill and a decode step, int8
    caches), and cross-attention; the cache after the call too."""
    int8 = case.startswith("int8")
    jcfg, tcfg = cfgs(qk_norm=True, rope_theta=1e4,
                      cache_dtype=jnp.int8 if int8 else None)
    tcfg = tcfg.replace(cache_dtype=torch.int8 if int8 else None)
    rng = np.random.default_rng(7)
    p = _attn_params(rng, qk_norm=case != "cross")
    s = {"decode": 1, "int8_decode": 1, "staged": 3}.get(case, 6)
    x = rn(rng, 2, s, 32)
    kw, tkw = {}, {}
    if case == "no_cache_window":
        kw["window"] = tkw["window"] = 2
    if case == "cross":
        enc = rn(rng, 2, 9, 32)
        kw["kv_x"], tkw["kv_x"] = jnp.asarray(enc), torch.from_numpy(enc)
        kw["causal"] = tkw["causal"] = False
    if "pos0" in case or case in ("staged", "decode", "int8_decode"):
        pos = 0 if "pos0" in case else 5
        c = _cache(2, 12, np.int8 if int8 else np.float32, pos, rng)
        kw["cache"] = jax.tree_util.tree_map(jnp.asarray, c)
        tkw["cache"] = params_from_numpy(c, "cpu")
    want, jcache = JATT.attention(jcfg, jax.tree_util.tree_map(
        jnp.asarray, p), jnp.asarray(x), None, **kw)
    calls = _Counting()
    got, tcache = ATT.attention(tcfg, params_from_numpy(p, "cpu"),
                                torch.from_numpy(x), None, impl=calls, **tkw)
    close(got, want, 2e-4)
    flash = case in ("no_cache", "no_cache_window", "cache_pos0",
                     "int8_pos0")
    assert calls.n == {"matmul": 4, "fused_add_rmsnorm": 0,
                       "flash_attention": int(flash)}
    if jcache is None:
        assert "cache" not in tkw
        return
    assert tcache is tkw["cache"]          # updated in place
    for name, w in jcache.items():
        if name == "pos":
            assert int(tcache[name]) == int(w)
        elif tcache[name].dtype == torch.int8:
            diff = np.abs(tcache[name].numpy().astype(np.int32)
                          - np.asarray(w, np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-2, name
        else:
            close(tcache[name], w, 2e-5)


def test_attend_precomputed_matches_jax():
    jcfg, tcfg = cfgs()
    rng = np.random.default_rng(8)
    p = _attn_params(rng, qk_norm=False)
    x, k, v = rn(rng, 2, 3, 32), rn(rng, 2, 9, 2, 16), rn(rng, 2, 9, 2, 16)
    want = JATT.attend_precomputed(jcfg, jax.tree_util.tree_map(
        jnp.asarray, p), *map(jnp.asarray, (x, k, v)), None)
    got = ATT.attend_precomputed(tcfg, params_from_numpy(p, "cpu"),
                                 *map(torch.from_numpy, (x, k, v)), None)
    close(got, want, 2e-4)


def test_kv_cache_init_and_specs_match_jax():
    jcfg, tcfg = cfgs()
    want = JATT.init_kv_cache(jcfg, 3, 2, 10)
    got = ATT.init_kv_cache(tcfg, 3, 2, 10, device="cpu")
    specs = ATT.kv_cache_specs(tcfg, 3, 2, 10)
    jspec = JATT.kv_cache_specs(jcfg, 3, 2, 10)
    for name in ("k", "v", "pos"):
        assert tuple(got[name].shape) == want[name].shape
        assert not got[name].any()
        assert specs[name] == TensorSpec(jspec[name].shape, got[name].dtype)
    assert got["pos"].dtype == torch.int32 and got["k"].dtype == torch.float32
    # rules are accepted (they raised before the sharding slice)
    ruled = ATT.init_kv_cache(tcfg, 3, 2, 10, rules={}, device="cpu")
    assert all(torch.equal(ruled[n], got[n]) for n in got)


# ---- parameters, interop, frontends ----------------------------------------

def test_init_params_std_rule_and_determinism():
    defs = {"w": ParamDef((64, 8, 16), ("embed", "heads", None)),
            "emb": ParamDef((4096, 32), ("vocab", "embed"), scale=2.0),
            "n": {"scale": ParamDef((32,), (None,), init="ones"),
                  "bias": ParamDef((32,), (None,), init="zeros")}}
    p = init_params(torch.Generator().manual_seed(3), defs, torch.float32)
    again = init_params(torch.Generator().manual_seed(3), defs,
                        torch.float32)
    assert all(torch.equal(a, b) for a, b in
               zip(jax.tree_util.tree_leaves(p),
                   jax.tree_util.tree_leaves(again)))
    # fan_in is shape[-2]: 8 heads for wq-shaped leaves, 4096 rows here
    assert abs(float(p["w"].std()) - 1 / np.sqrt(8)) < 0.02
    assert abs(float(p["emb"].std()) - 2 / np.sqrt(4096)) < 0.002
    assert torch.equal(p["n"]["scale"], torch.ones(32))
    assert torch.equal(p["n"]["bias"], torch.zeros(32))
    bf = init_params(torch.Generator().manual_seed(3), defs)
    assert bf["w"].dtype == torch.bfloat16
    assert param_count(defs) == 64 * 8 * 16 + 4096 * 32 + 64
    assert abstract_params(defs)["w"] == TensorSpec((64, 8, 16),
                                                    torch.bfloat16)
    with pytest.raises(ValueError):
        ParamDef((2, 3), ("a",))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_params_draws_a_stacked_leaf_one_layer_at_a_time(dtype):
    """A leaf stacked over layers is drawn layer by layer (a whole
    float32 draw of gemma3-27b's FFN stacks would not fit an 80 GB card):
    each layer holds what a draw of one layer's shape gives next from
    the generator; other leaves are drawn whole."""
    defs = {"a": ParamDef((3, 16, 8), ("layers", "embed", "ff")),
            "b": ParamDef((16, 4, 8), ("embed", "heads", None))}
    got = init_params(torch.Generator().manual_seed(11), defs, dtype)
    gen = torch.Generator().manual_seed(11)
    for i in range(3):
        want = torch.randn((16, 8), generator=gen) / np.sqrt(16)
        assert torch.equal(got["a"][i], want.to(dtype))
    want = torch.randn((16, 4, 8), generator=gen) / np.sqrt(4)
    assert torch.equal(got["b"], want.to(dtype))
    assert got["a"].dtype == dtype and got["a"].is_contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_params_draws_float32_in_place(dtype):
    """A float32 leaf is drawn into its own storage: the only tensor of
    its size made is the leaf (llama4's float32 expert stacks would be
    held twice otherwise), with the bits a ``randn`` draw gives.  A
    bfloat16 leaf still makes its float32 draw beside it."""
    from torch.utils._python_dispatch import TorchDispatchMode
    d = ParamDef((4, 64, 32), ("experts", "embed", "expert_ff"))
    made = []

    class Made(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            res = func(*args, **(kwargs or {}))
            if (not func.is_view and not func._schema.is_mutable
                    and isinstance(res, torch.Tensor)
                    and res.numel() == 4 * 64 * 32):
                made.append((str(func), res.dtype))
            return res

    with Made():
        got = init_params(torch.Generator().manual_seed(5), {"w": d}, dtype)
    want = torch.randn(d.shape, generator=torch.Generator().manual_seed(5))
    assert torch.equal(got["w"], want.mul_(1 / np.sqrt(64)).to(dtype))
    if dtype == torch.float32:
        assert made == [("aten.empty.memory_format", torch.float32)]
    else:
        assert ("aten.randn.generator", torch.float32) in made


def test_params_from_numpy_keeps_bf16_bits():
    """A JAX bf16 tree crosses leaf for leaf with the same bits, ints
    and nesting too."""
    rng = np.random.default_rng(9)
    tree = {"a": {"w": jnp.asarray(rn(rng, 3, 5), jnp.bfloat16),
                  "pos": jnp.asarray([0, 4], jnp.int32)},
            "b": jnp.asarray(rn(rng, 4))}
    got = params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")
    assert got["a"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["a"]["w"].view(torch.int16).numpy(),
        np.asarray(tree["a"]["w"]).view(np.int16))
    assert got["a"]["pos"].dtype == torch.int32
    np.testing.assert_array_equal(got["b"].numpy(), np.asarray(tree["b"]))


@pytest.mark.parametrize("kw", [dict(encoder_layers=2, encoder_seq=24),
                                dict(n_patches=8), {}])
def test_frontend_stubs(kw):
    jcfg, tcfg = cfgs(**kw)
    want = jspecs(jcfg, 3)
    specs = frontend_input_specs(tcfg, 3)
    assert {k: s.shape for k, s in specs.items()} == \
        {k: s.shape for k, s in want.items()}
    gen = torch.Generator().manual_seed(0)
    out = synth_frontend_inputs(tcfg, 3, gen, device="cpu")
    assert sorted(out) == sorted(specs)
    for name, t in out.items():
        assert tuple(t.shape) == specs[name].shape
        assert t.dtype == torch.float32
        assert 0.015 < float(t.std()) < 0.025

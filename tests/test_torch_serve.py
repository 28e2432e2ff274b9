"""The port's serving module ``repro_torch.launch.serve`` against the JAX
package's, and the kernel routing of ``Model``.

* Greedy generation through ``make_prefill_step`` and ``make_serve_step``
  gives the tokens the JAX functions give on the same numpy prompts and
  weights (qwen3 and gemma3 reduced, float32).  ``serve_loop`` draws its
  prompts from a ``torch.Generator``, so its tokens are not the JAX
  demo's; it is held to its shape and to the steps it is made of.
* ``serve_loop`` runs on the CPU when asked and raises without CUDA
  otherwise.
* A counting ``impl`` sees ``7 n_layers + 1`` GEMMs, ``2 n_layers + 1``
  fused add+RMSNorms and ``n_layers`` flash attentions in a prefill, and
  the same less the attentions in a decode step, for the attention
  models; for mamba2 (2 GEMMs a layer, no FFN), recurrentgemma (5 a
  RG-LRU layer) and granite (the router and 3 GEMMs for each of its
  experts a layer) the counts ``test_torch_decode.kernel_calls`` reckons
  from the configuration; the kernels' own launch counters stay at 0 on
  the CPU.  Greedy tokens of mamba2 and recurrentgemma equal the JAX
  steps' too.
* ``chip_smoke.py``'s launch reckoning (``serve_launches``) and its
  controls (``reordered_plain``, ``routing_flips``) hold on the CPU.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_decode import kernel_calls  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.common import ParamDef as JParamDef  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import forward as F  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

B, PROMPT, GEN = 3, 12, 8


def _setup(arch, seed=0):
    jcfg = jreduced(jget_config(arch)).replace(dtype=jnp.float32,
                                               remat=False)
    tcfg = reduced(get_config(arch)).replace(dtype=torch.float32,
                                             remat=False)
    rng = np.random.default_rng(seed)

    def leaf(d):
        z = rng.standard_normal(d.shape).astype(np.float32)
        if d.init != "normal":
            return np.float32(d.init == "ones") + np.float32(0.1) * z
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        return z * np.float32(d.scale / np.sqrt(max(1, fan_in)))
    p = jax.tree_util.tree_map(leaf, JModel(jcfg).param_defs(),
                               is_leaf=lambda x: isinstance(x, JParamDef))
    prompts = rng.integers(0, tcfg.vocab_size, (B, PROMPT), dtype=np.int32)
    return (JModel(jcfg), jax.tree_util.tree_map(jnp.asarray, p)), \
        (Model(tcfg), params_from_numpy(p, "cpu")), prompts


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-27b", "mamba2-130m",
                                  "recurrentgemma-9b"])
def test_greedy_generation_matches_jax(arch):
    (jm, jp), (tm, tp), prompts = _setup(arch)
    max_len = PROMPT + GEN + 8
    jprefill = jax.jit(jserve.make_prefill_step(jm, None, max_len))
    jstep = jax.jit(jserve.make_serve_step(jm, None))
    prefill = serve.make_prefill_step(tm, None, max_len)
    step = serve.make_serve_step(tm, None)

    jlast, jcache = jprefill(jp, {"tokens": jnp.asarray(prompts)})
    last, cache = prefill(tp, {"tokens": torch.from_numpy(prompts)})
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=0,
                               atol=2e-4)
    jtok = jnp.argmax(jlast, -1).astype(jnp.int32)[:, None]
    tok = torch.argmax(last, -1).to(torch.int32)[:, None]
    jout, out = [jtok], [tok]
    for _ in range(GEN - 1):
        jnxt, jcache = jstep(jp, jcache, jtok)
        nxt, cache = step(tp, cache, tok)
        assert nxt.dtype == torch.int32
        jtok, tok = jnxt[:, None], nxt[:, None]
        jout.append(jtok)
        out.append(tok)
    want = np.asarray(jnp.concatenate(jout, axis=1))
    got = torch.cat(out, dim=1).numpy()
    np.testing.assert_array_equal(got, want)
    attn = [f"blk{gi}" for gi, e in enumerate(tm.cfg.pattern)
            if e.startswith("attn")]
    for key in attn:
        assert int(cache[key]["pos"][0]) == PROMPT + GEN - 1


def test_serve_loop_on_cpu():
    logs = []
    out = serve.serve_loop("qwen3-0.6b", batch=2, prompt_len=5, gen=4,
                           device="cpu", log=logs.append)
    assert out["generated"].shape == (2, 4)
    assert out["generated"].dtype == np.int32
    assert (out["generated"] >= 0).all() and \
        (out["generated"] < reduced(get_config("qwen3-0.6b"))
         .vocab_size).all()
    assert out["elapsed_s"] > 0 and "on cpu" in logs[0]
    again = serve.serve_loop("qwen3-0.6b", batch=2, prompt_len=5, gen=4,
                             device="cpu", log=logs.append)
    np.testing.assert_array_equal(again["generated"], out["generated"])


def test_serve_loop_leaves_room_for_the_patches(monkeypatch):
    """pixtral's stub patches come ahead of the prompt in the cache:
    with more patches than the 8 spare rows of ``prompt_len + gen + 8``
    (pixtral-12b has 64) the loop still serves, and its tokens equal a
    prefill and steps over a cache with room to spare."""
    cfg = reduced(get_config("pixtral-12b")).replace(n_patches=24)
    monkeypatch.setattr(serve, "get_config", lambda arch: cfg)
    out = serve.serve_loop("pixtral-12b", batch=2, prompt_len=5, gen=4,
                           use_reduced=False, device="cpu", log=lambda _: 0)
    cfg32 = cfg.replace(dtype=torch.float32, remat=False)
    model = Model(cfg32)
    params = model.init(torch.Generator().manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (2, 5),
                            generator=torch.Generator().manual_seed(1))
    extras = serve.synth_frontend_inputs(cfg32, 2, device="cpu")
    last, cache = serve.make_prefill_step(model, None, 100)(
        params, {"tokens": prompts, **extras})
    tok = torch.argmax(last, -1).to(torch.int32)[:, None]
    toks = [tok]
    step = serve.make_serve_step(model, None)
    for _ in range(3):
        nxt, cache = step(params, cache, tok)
        tok = nxt[:, None]
        toks.append(tok)
    np.testing.assert_array_equal(out["generated"],
                                  torch.cat(toks, 1).numpy())


def test_serve_loop_main_on_cpu(capsys):
    serve.main(["--arch", "whisper-tiny", "--batch", "2", "--prompt-len",
                "4", "--gen", "3", "--device", "cpu"])
    assert "served 2 requests x 3 tokens" in capsys.readouterr().out


def test_serve_loop_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve.serve_loop("qwen3-0.6b", batch=1, prompt_len=2, gen=2)


def test_serve_steps_reject_rules():
    """The steps take rules since the sharding slice: with ``PROD_RULES``
    on plain tensors the logits and tokens are the unruled steps' bit
    for bit.  (The name dates from when rules raised; it is kept so that
    the test's record runs on.)"""
    from types import SimpleNamespace
    from repro_torch.models.common import PROD_RULES, with_axis_sizes
    cfg = reduced(get_config("qwen3-0.6b")).replace(dtype=torch.float32)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 6),
                           generator=torch.Generator().manual_seed(1))
    sized = with_axis_sizes(PROD_RULES, SimpleNamespace(
        mesh_dim_names=("data", "model"), shape=(1, 1)))
    outs = []
    for rules in (None, sized):
        last, cache = serve.make_prefill_step(model, rules, 8)(
            params, {"tokens": tokens})
        nxt, _ = serve.make_serve_step(model, rules)(
            params, cache, last.argmax(-1, keepdim=True).to(torch.int32))
        outs.append((last, nxt))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


class Counting:
    """The plain versions, each call counted."""

    def __init__(self):
        self.n = dict.fromkeys(("matmul", "fused_add_rmsnorm",
                                "flash_attention"), 0)

    def __getattr__(self, name):
        fn = getattr(F.PLAIN, name)

        def call(*args, **kwargs):
            self.n[name] += 1
            return fn(*args, **kwargs)
        return call


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-27b", "smollm-360m",
                                  "mamba2-130m", "recurrentgemma-9b",
                                  "granite-moe-1b-a400m"])
def test_kernel_calls_of_prefill_and_decode(arch):
    cfg = reduced(get_config(arch)).replace(dtype=torch.float32)
    counting = Counting()
    model = Model(cfg, impl=counting)
    plain = Model(cfg, impl=F.PLAIN)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 10),
                           generator=torch.Generator().manual_seed(1))
    before = {k: c.launches for k, c in ops.launch_counters().items()}
    n = cfg.n_layers
    last, cache = model.prefill(params, tokens[:, :8], max_len=16)
    assert counting.n == kernel_calls(cfg, prefill=True)
    if cfg.pattern == ("attn",):
        assert counting.n == {"matmul": 7 * n + 1,
                              "fused_add_rmsnorm": 2 * n + 1,
                              "flash_attention": n}
    plast, pcache = plain.prefill(params, tokens[:, :8], max_len=16)
    assert torch.equal(last, plast)
    for i in (8, 9):
        counting.n = dict.fromkeys(counting.n, 0)
        lg, cache = model.decode_step(params, tokens[:, i:i + 1], cache)
        assert counting.n == kernel_calls(cfg, prefill=False)
        plg, pcache = plain.decode_step(params, tokens[:, i:i + 1], pcache)
        assert torch.equal(lg, plg)
    # the kernels' counters count launches on the card only
    assert {k: c.launches for k, c in ops.launch_counters().items()} == \
        before


def test_layernorm_model_adds_in_plain_pytorch():
    """stablelm (LayerNorm) routes its GEMMs and prefill attention
    through ``impl`` and none of its norms."""
    cfg = reduced(get_config("stablelm-1.6b")).replace(dtype=torch.float32)
    counting = Counting()
    model = Model(cfg, impl=counting)
    params = model.init(torch.Generator().manual_seed(0))
    model.prefill(params, torch.zeros((1, 6), dtype=torch.int64), 8)
    n = cfg.n_layers
    assert counting.n == {"matmul": 7 * n + 1, "fused_add_rmsnorm": 0,
                          "flash_attention": n}


def test_tied_head_copied_once_a_model():
    cfg = reduced(get_config("qwen3-0.6b")).replace(dtype=torch.float32)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    head = model.head(params)
    assert head.is_contiguous() and tuple(head.shape) == (cfg.d_model,
                                                          cfg.vocab_size)
    assert torch.equal(head, params["embed"]["embedding"].t())
    tokens = torch.zeros((1, 3), dtype=torch.int64)
    model.forward(params, tokens)
    assert model.head(params) is head
    with torch.no_grad():
        params["embed"]["embedding"].mul_(2)
    again = model.head(params)
    assert again is not head
    assert torch.equal(again, params["embed"]["embedding"].t())


def _smoke():
    """``chip_smoke.py`` as a module (its ``main`` is not run)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_launch_reckoning_matches_the_configs():
    """``chip_smoke.serve_launches`` (the launches phases 16 and 18 hold
    on the card) equals this file's reckoning for all ten full-size
    configs, and the counts the phases print."""
    from repro_torch.configs import ARCHS
    smoke = _smoke()
    for arch in ARCHS:
        cfg = get_config(arch)
        if cfg.norm_type != "rmsnorm":
            continue
        for prefill in (True, False):
            assert smoke.serve_launches(cfg, prefill) == \
                kernel_calls(cfg, prefill), (arch, prefill)
    want = {"qwen3-0.6b": (197, 57, 28), "granite-moe-1b-a400m":
            (2425, 49, 24), "mamba2-130m": (49, 25, 0),
            "recurrentgemma-9b": (293, 77, 12)}
    for arch, (mm, norms, attn) in want.items():
        assert smoke.serve_launches(get_config(arch), True) == {
            "matmul": mm, "fused_add_rmsnorm": norms,
            "flash_attention": attn}


def test_chip_smoke_controls():
    """The reordered control computes the plain GEMM's function (float32
    sums in another order); ``routing_flips`` counts the (token, layer)
    pairs whose sets of experts differ, over the calls both runs made."""
    from repro_torch.models.moe import Routing
    smoke = _smoke()
    gen = torch.Generator().manual_seed(0)
    a, b = torch.randn(33, 70, generator=gen), torch.randn(70, 9,
                                                           generator=gen)
    got = smoke.reordered_plain().matmul(a, b)
    np.testing.assert_allclose(got.numpy(), F.PLAIN.matmul(a, b).numpy(),
                               rtol=1e-5, atol=1e-5)
    one, two = Routing(), Routing()
    one(torch.tensor([[[0, 1], [2, 3]]]))
    one(torch.tensor([[[4, 5]]]))
    two(torch.tensor([[[1, 0], [2, 1]]]))       # the same set, then not
    assert smoke.routing_flips(one, two) == (1, 2)


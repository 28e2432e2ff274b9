"""The port's hill-climb (``repro_torch.launch.hillclimb``) against the
JAX package's (``repro.launch.hillclimb``), on the CPU:

* ``block_skip_factor`` equal on a grid of sequences and windows;
* the kernel-true bytes of ``attention_bytes_per_layer`` equal, for
  training and inference, on four configs;
* the GEMM FLOPs of the attention each walks -- the port's dense plain
  attention (what its ``Model`` traces), the reference's chunked one --
  equal in a forward where the sequence fills its key blocks; the
  reference's extra FLOPs are its chunk padding (4 * B * S * pad * H *
  hd a forward, twice that again for the backward's products) and, in a
  gradient, the logits product its backward scan rematerializes (2 * B
  * S * T * H * hd over the padded keys T);
* ``apply_flash_substitution`` and ``flops_skip_delta`` equal to the
  reference's given the same per-layer walks (both modules' walker
  patched to one formula), on every config whose pattern has no MoE
  layer; on granite and llama4 the port substitutes every attention
  layer where the reference's ``kind == "attn"`` leaves out the
  ``attn+moe`` ones (the named difference);
* a training layer's walked attention under remat holding the recompute
  forward (the reference's ``fwd.bytes + grad.bytes``);
* ``CELLS`` with the reference's cells and variant names; ``run_cell``
  over gemma3's variants with the dry run stood in for by the reduced
  config's walk (the remat variants give records of their own, ordered
  as the reference's policies), and ``main`` over
  ``qwen3_decode`` on the ``fake`` backend in a subprocess (the 2-D
  cache and int8 KV cut the bytes a device holds, as they should).

Exact comparisons, but the substituted roofline (float arithmetic on the
same inputs, 1e-12 relative).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from test_torch_costmodel import _jax_dot_flops  # noqa: E402
from test_torch_ranks import ROOT, env  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import attention as JATT  # noqa: E402

from repro_torch.configs import ARCHS, get_config, reduced  # noqa: E402
from repro_torch.kernels.forward import PLAIN  # noqa: E402
from repro_torch.launch import dryrun, hillclimb  # noqa: E402
from repro_torch.launch.costmodel import graph_cost  # noqa: E402
from repro_torch.models import attention as ATT  # noqa: E402


@pytest.fixture(scope="module")
def jhill():
    """The JAX package's hill-climb module, imported without letting its
    ``XLA_FLAGS`` default (512 host devices) reach later subprocesses."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import hillclimb as module
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return module


def test_block_skip_factor_equals_the_reference(jhill):
    for seq in (1, 64, 1000, 4096, 32768):
        for window in (0, 1, 63, 512, 1024, 4096, 40000):
            assert hillclimb.block_skip_factor(seq, window) == \
                jhill.block_skip_factor(seq, window)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-27b",
                                  "recurrentgemma-9b", "smollm-360m"])
def test_kernel_bytes_equal_the_reference(jhill, arch, training):
    got = hillclimb.attention_bytes_per_layer(
        reduced(get_config(arch)), 2, 64, training)
    want = jhill.attention_bytes_per_layer(
        jreduced(jget_config(arch)).replace(attn_block=32), 2, 64, training)
    assert got["kernel_bytes"] == want["kernel_bytes"]
    assert got["delta"] == got["xla_bytes"] - got["kernel_bytes"]


def _port_attention_gemm(cfg, b, s, training, window):
    def attn(q, k, v):
        return ATT._flash(PLAIN, q, k, v, True, window)
    q, k, v = (torch.empty((b, s, n, cfg.hd), dtype=cfg.dtype,
                           device="meta", requires_grad=training)
               for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    if not training:
        return graph_cost(attn, q, k, v).gemm_flops

    def grad(q, k, v):
        out = attn(q, k, v).float().sum()
        return torch.autograd.grad(out, (q, k, v))
    return graph_cost(grad, q, k, v).gemm_flops


def _jax_attention_dots(cfg, b, s, training, window):
    q = jax.ShapeDtypeStruct((b, s, cfg.n_heads, cfg.hd), cfg.dtype)
    k = jax.ShapeDtypeStruct((b, s, cfg.n_kv_heads, cfg.hd), cfg.dtype)
    pos = jnp.arange(s)

    def attn(q, k, v):
        return JATT._chunked_attention_dynwin(
            q, k, v, pos, pos, True, jnp.asarray(window), cfg.attn_block)
    if not training:
        return _jax_dot_flops(jax.make_jaxpr(attn)(q, k, k).jaxpr)

    def loss(q, k, v):
        return attn(q, k, v).astype(jnp.float32).sum()
    return _jax_dot_flops(jax.make_jaxpr(jax.grad(
        loss, argnums=(0, 1, 2)))(q, k, k).jaxpr)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("seq,pad", [(64, 0), (56, 8)])
@pytest.mark.parametrize("window", [0, 16])
def test_attention_gemm_flops_equal_the_reference(seq, pad, window,
                                                  training):
    cfg = reduced(get_config("gemma3-27b"))
    jcfg = jreduced(jget_config("gemma3-27b")).replace(attn_block=32)
    b = 2
    got = _port_attention_gemm(cfg, b, seq, training, window)
    want = _jax_attention_dots(jcfg, b, seq, training, window)
    padding = 4 * b * seq * pad * cfg.n_heads * cfg.hd * (3 if training
                                                          else 1)
    # the reference's backward scan rematerializes each key block's
    # logits product ("rematted_computation" in its jaxpr)
    remat = 2 * b * seq * (seq + pad) * cfg.n_heads * cfg.hd * training
    assert want - got == padding + remat


def _walk_formula(batch, seq, training, window):
    """A stand-in per-layer walk, the same for both modules."""
    base = float(batch * seq * (3 if training else 1))
    return {"xla_bytes": base * 1000.0 + window,
            "kernel_bytes": base * 10.0,
            "delta": base * 990.0 + window,
            "xla_flops": base * 77.0 + 3 * window}


def _patch(monkeypatch, jhill):
    def walk(cfg, batch, seq, training):
        return _walk_formula(batch, seq, training, cfg.window)
    monkeypatch.setattr(hillclimb, "attention_bytes_per_layer", walk)
    monkeypatch.setattr(jhill, "attention_bytes_per_layer", walk)


def _record():
    return {"arch": "x", "status": "ok", "roofline": {
        "flops": 8.0e18, "hbm_bytes": 9.0e16, "collective_bytes": 1.0e12,
        "chips": 256, "model_flops": 4.0e18}}


MOE = {"granite-moe-1b-a400m", "llama4-maverick-400b-a17b"}


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_flash_substitution_equals_the_reference(monkeypatch, jhill, arch,
                                                 shape):
    from repro.launch.shapes import SHAPES as JSHAPES
    from repro.launch.shapes import adjust_config as jadjust
    from repro_torch.launch.shapes import SHAPES, adjust_config
    _patch(monkeypatch, jhill)
    cfg = adjust_config(get_config(arch), SHAPES[shape])
    jcfg = jadjust(jget_config(arch), JSHAPES[shape])
    got = hillclimb.apply_flash_substitution(_record(), cfg, shape,
                                             skip=True)
    want = jhill.apply_flash_substitution(_record(), jcfg, shape, skip=True)
    if shape == "decode_32k":
        assert got == want == _record()
        return
    g, w = got["roofline"], want["roofline"]
    attn = sum(1 for k in cfg.layer_kinds() if k.split("+")[0] == "attn")
    plain_attn = sum(1 for k in cfg.layer_kinds() if k == "attn")
    assert g["flash_substitution"]["n_attn_layers"] == attn
    assert w["flash_substitution"]["n_attn_layers"] == plain_attn
    if arch in MOE:
        # the reference leaves out the attn+moe layers
        assert attn > plain_attn
        return
    for key in ("hbm_bytes", "flops", "model_flops", "model_flops_ratio",
                "flash_substitution"):
        assert g[key] == pytest.approx(w[key], rel=1e-12), key
    s = SHAPES[shape]
    assert hillclimb.flops_skip_delta(
        cfg, s.global_batch, s.seq, s.kind == "train") == pytest.approx(
        jhill.flops_skip_delta(jcfg, s.global_batch, s.seq,
                               s.kind == "train"), rel=1e-12)


def test_substitution_takes_a_cut_batch(monkeypatch, jhill):
    _patch(monkeypatch, jhill)
    cfg = get_config("qwen3-0.6b")
    whole = hillclimb.apply_flash_substitution(_record(), cfg, "train_4k")
    cut = hillclimb.apply_flash_substitution(_record(), cfg, "train_4k",
                                             batch=2)
    assert whole["roofline"]["flash_substitution"]["delta"] == \
        128 * cut["roofline"]["flash_substitution"]["delta"]


def test_cells_and_variants_equal_the_reference(jhill):
    assert list(hillclimb.CELLS) == list(jhill.CELLS)
    for name, spec in hillclimb.CELLS.items():
        want = jhill.CELLS[name]
        assert (spec["arch"], spec["shape"]) == (want["arch"],
                                                 want["shape"])
        assert list(spec["variants"]) == list(want["variants"])
        for v, body in spec["variants"].items():
            assert sorted(body) == sorted(want["variants"][v])


def test_run_cell_gives_the_remat_variants_records_of_their_own(
        monkeypatch, tmp_path):
    """``flash+save_dots`` and ``flash+save_mixer`` trace their own
    policy: with the dry run's trace stood in for by the walk of the
    reduced config's train step under each variant's overrides, their
    FLOPs differ from ``flash``'s (the default ``full``) in the
    reference's order, save_dots < save_mixer < full, and no record
    carries a ``remat`` tag."""
    def stub(arch, shape, multi_pod, rules_override=None,
             cfg_override=None):
        cfg = reduced(get_config(arch)).replace(**(cfg_override or {}))
        fn, args = dryrun.step_program(cfg, "train", 2, 32)
        rec = _record()
        rec["roofline"]["flops"] = graph_cost(fn, *args).flops
        return rec, None
    monkeypatch.setattr(hillclimb, "lower_cell", stub)
    hillclimb.run_cell("gemma3_train", tmp_path)
    recs = {p.name.split(".")[1]: json.loads(p.read_text())
            for p in tmp_path.glob("gemma3_train.*.json")}
    assert sorted(recs) == sorted(hillclimb.CELLS["gemma3_train"]
                                  ["variants"])
    assert "flash_substitution" not in recs["baseline"]["roofline"]
    assert not any("remat" in rec for rec in recs.values())
    flops = {v: recs[v]["roofline"]["flops"] for v in recs}
    assert flops["flash+save_dots"] < flops["flash+save_mixer"] < \
        flops["flash"] == flops["baseline"]
    assert recs["flash+skip"]["roofline"]["flops"] < \
        recs["flash"]["roofline"]["flops"]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-27b"])
def test_attention_bytes_count_the_recompute_forward(arch):
    """A training layer under remat (every policy recomputes attention)
    walks one forward more than without: the reference's ``fwd.bytes +
    grad.bytes``; the kernel's bytes do not move."""
    cfg = reduced(get_config(arch))
    on = hillclimb.attention_bytes_per_layer(cfg, 2, 64, True)
    off = hillclimb.attention_bytes_per_layer(cfg.replace(remat=False), 2,
                                              64, True)

    def attn(q, k, v):
        return ATT._flash(PLAIN, q, k, v, True, int(cfg.window))
    fwd = graph_cost(attn, *(torch.empty((2, 64, n, cfg.hd),
                                         dtype=cfg.dtype, device="meta")
                             for n in (cfg.n_heads, cfg.n_kv_heads,
                                       cfg.n_kv_heads)))
    assert on["xla_bytes"] == off["xla_bytes"] + fwd.bytes > off["xla_bytes"]
    assert on["xla_flops"] == off["xla_flops"] + fwd.flops
    assert on["kernel_bytes"] == off["kernel_bytes"]
    inference = hillclimb.attention_bytes_per_layer(cfg, 2, 64, False)
    assert inference["xla_bytes"] == fwd.bytes


CLIMB = r"""
import json, sys, tempfile
from pathlib import Path
from repro_torch.launch import hillclimb
with tempfile.TemporaryDirectory() as tmp:
    hillclimb.main(["--cell", "qwen3_decode", "--out", tmp])
    print("CLIMB " + json.dumps({p.name: json.loads(p.read_text())
                                 for p in Path(tmp).glob("*.json")}))
"""


def test_main_over_qwen3_decode_on_the_fake_backend():
    res = subprocess.run([sys.executable, "-c", CLIMB], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=env())
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith("CLIMB ")]
    assert lines, res.stdout[-3000:] + res.stderr[-3000:]
    recs = json.loads(lines[-1][len("CLIMB "):])
    arg = {name.split(".")[1]: r["memory"]["argument_bytes"]
           for name, r in recs.items()}
    assert set(arg) == {"baseline", "cache2d", "cache2d+int8kv"}
    assert arg["cache2d+int8kv"] < arg["cache2d"] < arg["baseline"]
    assert all(r["status"] == "ok" for r in recs.values())
    # every variant reads rank 0's program, the two with the cache's
    # sequence on model too: temp bytes and a collective term
    for r in recs.values():
        assert isinstance(r["memory"]["temp_bytes"], int)
        assert r["memory"]["temp_bytes"] > 0
        assert r["roofline"]["t_collective_s"] > 0

"""The partitioned route (``kernels.ops.partitioned``: the kernels on the
local shards of ``DTensor``s, ``local_map``) against the port's
unpartitioned route and the JAX package's ``jax.jit(in_shardings=...)``
steps, on the CPU.

Four ``gloo`` ranks (``test_torch_ranks.run_ranks``) on a (2, 2)
``("data", "model")`` mesh, float32, ``PROD_RULES`` sized to it, the
state placed by ``make_state_shardings`` and the batch by
``batch_shardings``; the same numpy weights and tokens
(``test_torch_decode.numpy_params``), and a front-end config's frames or
patches, go through both routes and, in a subprocess with 4 forced host
devices, through the reference's jitted steps on a (2, 2) mesh; a
case's cache holds its patch prefix too (``max_len``).  The cases:

* reduced Qwen3-0.6B with a 512-token vocabulary: every head and the
  vocabulary split on ``model``, the weights on ``data`` (FSDP);
* reduced SmolLM-360M (4 query heads, 1 KV head, vocabulary 503): the
  KV heads do not divide ``model`` = 2, so each rank reads the one KV
  head whole; the vocabulary stays whole;
* SmolLM with 15 query and 5 KV heads: every head axis falls back to
  replicated;
* stablelm-1.6b (LayerNorm, 25% rotary, MHA) and gemma3-27b (sliding
  windows on 5 of 6 layers, GELU), reduced: the other attention
  decoders the slice runs unchanged;
* Qwen3 under remat ``full`` with a chunked, padded cross-entropy (loss,
  gradients and the step).

Held, against both references, each gathered with ``full_tensor``: the
prefill's last logits and two decode steps' logits (1e-4 relative
Frobenius; against the port's unpartitioned route also the tokens of
``make_serve_step``, equal, and its cache, 1e-4), ``Model.loss`` (1e-6
relative), every gradient (1e-4 relative Frobenius) and one ``make_train_step``
AdamW update's parameters and moments (1e-3 relative Frobenius): the
limits of ``tests/test_torch_train.py``.  Local shapes are held too:
Qwen3's logits stay split on the vocabulary, and no collective of its
training step returns the vocabulary whole.

Every config builds on a mesh of more than one rank: the MoE configs
(their cases are in ``tests/test_torch_partitioned_moe.py``),
mamba2-130m and recurrentgemma-9b (``tests/
test_torch_partitioned_ssm.py``, ``tests/test_torch_partitioned_rglru
.py``), whisper-tiny and pixtral-12b (``tests/
test_torch_partitioned_frontends.py``).  A ``DTensor`` handed to a
kernel wrapper outside ``local_map`` raises.
"""
import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_decode import numpy_params  # noqa: E402
from test_torch_ranks import ROOT, env, run_ranks  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402

CASES = {
    "qwen3": ("qwen3-0.6b", {"vocab_size": 512}),
    "smollm": ("smollm-360m", {}),
    "smollm_15x5": ("smollm-360m", {"n_heads": 15, "n_kv_heads": 5}),
    "stablelm": ("stablelm-1.6b", {}),
    "gemma3": ("gemma3-27b", {}),
    "qwen3_remat": ("qwen3-0.6b", {"vocab_size": 512, "remat": True,
                                   "remat_policy": "full", "ce_chunk": 5}),
}
BATCH, SEQ, MAX_LEN, DECODE = 4, 12, 16, 2
LIMITS = {"prefill": 1e-4, "decode": 1e-4, "cache": 1e-4, "loss": 1e-6,
          "grads": 1e-4, "params": 1e-3, "m": 1e-3, "v": 1e-3}

COMMON = """
import json, sys
import numpy as np
CASES = json.loads(sys.argv[1]) if len(sys.argv) > 1 else None
BATCH, SEQ, MAX_LEN, DECODE = %d, %d, %d, %d


def nested(flat):
    out = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def layout(kw):
    # a case's mesh (shape and axis names: kw["mesh"], (2, 2) by default;
    # three axes are ("pod", "data", "model") under the multi-pod rules),
    # its serving layout (CASE_KEYS: "rules", changes to the production
    # rules, a list naming a tuple of mesh axes; "batch"; "max_len", the
    # cache's rows; "int8", an int8 cache) and its config changes
    kw = dict(kw)
    shape = tuple(kw.pop("mesh", (2, 2)))
    names = ("pod", "data", "model")[-len(shape):]
    rules = {k: tuple(v) if isinstance(v, list) else v
             for k, v in kw.pop("rules", {}).items()}
    extra = {"rules": rules, "batch": kw.pop("batch", BATCH),
             "max_len": kw.pop("max_len", MAX_LEN),
             "int8": kw.pop("int8", False)}
    return shape, names, kw, extra


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


# a case's front-end inputs (whisper's frames, pixtral's patches) beside
# its tokens, and its cache's rows: room for the patch prefix too
FRONT_ENDS = ("frames", "patches")


def max_len(cfg, extra):
    return extra["max_len"] + cfg.n_patches
""" % (BATCH, SEQ, MAX_LEN, DECODE)

# the port: each rank runs both routes and holds one against the other;
# rank 0 writes the partitioned route's gathered results for the JAX hold
PORT = COMMON + """
import os
from torch.distributed.tensor import DTensor, Shard
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.program import StepReader
from repro_torch.models.common import (PROD_RULES, multipod, place,
                                       tree_map, with_axis_sizes)
from repro_torch.models.transformer import Model
from repro_torch.optim.optimizers import AdamW, cosine_schedule

DIR = os.environ["CASE_DIR"]
CASES = json.loads(os.environ["CASES"])


def leaves(t):
    out = []
    tree_map(out.append, t)
    return out


def copy(tree):
    return tree_map(lambda t: t.clone(), tree)


def full(t):
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach()


def rel(a, b):
    a, b = full(a).double(), full(b).double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def one(name, arch, kw, mesh, rules, extra):
    cfg = reduced(get_config(arch)).replace(dtype=torch.float32,
                                            **{"remat": False, **kw})
    if extra["int8"]:
        cfg = cfg.replace(cache_dtype=torch.int8)
    data = np.load(f"{DIR}/{name}.npz")
    params = params_from_numpy(nested({k[2:]: data[k] for k in data.files
                                       if k.startswith("p/")}), "cpu")
    tokens = torch.from_numpy(data["tokens"])
    batch = {"tokens": tokens, **{k: torch.from_numpy(data[k])
                                  for k in FRONT_ENDS if k in data.files}}
    plain = Model(cfg)
    model = Model(cfg, impl=ops.partitioned(None, mesh, rules))
    opt = AdamW(schedule=cosine_schedule(1e-2, 2, 10))
    sh = train.make_state_shardings(model, opt, rules, mesh)
    bsh = train.batch_shardings(mesh, rules, batch)
    dparams = place(params, sh["params"])
    dtok = place(batch, bsh)
    out, err, keep = {}, {}, {}
    if not cfg.remat:
        lw, cw = serve.make_prefill_step(plain, None, max_len(cfg, extra))(
            params, batch)
        lg, cg = serve.make_prefill_step(model, rules, max_len(cfg, extra))(
            dparams, dtok)
        err["prefill"] = rel(lg, lw)
        keep["prefill"] = full(lg)
        out["logits_local"] = list(lg.to_local().shape)
        out["logits_pl"] = [str(p) for p in lg.placements]
        out["cache_k_local"] = [list(leaf.to_local().shape) for key, leaf
                                in flat(cg).items() if key.endswith("/k")]
        step_w = serve.make_serve_step(plain, None)
        step_g = serve.make_serve_step(model, rules)
        tw = torch.argmax(lw, -1).to(torch.int32)[:, None]
        tg = place(tw, bsh["tokens"])
        err["decode"] = 0.0
        same = True
        for i in range(DECODE):
            # the logits from copies of the caches; the tokens and the
            # caches through the serve steps, each feeding the next
            lw = plain.decode_step(params, tw, copy(cw))[0]
            lg = model.decode_step(dparams, tg, copy(cg), rules)[0]
            err["decode"] = max(err["decode"], rel(lg, lw))
            keep[f"decode{i}"] = full(lg)
            nw, cw = step_w(params, cw, tw)
            ng, cg = step_g(dparams, cg, tg)
            same &= bool(torch.equal(full(ng), nw)
                         and torch.equal(nw, torch.argmax(lw, -1).to(
                             torch.int32)))
            tw, tg = nw[:, None], ng[:, None]
        out["tokens_equal"] = same
        err["cache"] = max(rel(g, w) for g, w in zip(leaves(cg),
                                                     leaves(cw)))
    p = train.trainable(params)
    state = {"params": p, "opt": opt.init(p)}
    dp = train.trainable(dparams)
    dstate = {"params": dp, "opt": opt.init(dp)}
    lw, _ = plain.loss(p, batch)
    gw = torch.autograd.grad(lw, leaves(p))
    reader = StepReader()
    with reader:
        lg, _ = model.loss(dp, dtok, rules)
        gg = torch.autograd.grad(lg, leaves(dp))
    err["loss"] = abs(float(full(lg)) - float(lw)) / abs(float(lw))
    err["grads"] = max(rel(g, w) for g, w in zip(gg, gw))
    logits_shape = [BATCH, SEQ - 1, cfg.vocab_size]
    out["whole_vocab_collectives"] = sum(
        1 for _, shape in reader.calls if list(shape[-1:]) == [
            cfg.vocab_size] and np.prod(shape) >= np.prod(logits_shape) // 4)
    new_w, _ = train.make_train_step(plain, opt, None)(state, batch)
    new_g, _ = train.make_train_step(model, opt, rules)(dstate, dtok)
    for part, got, want in (("params", new_g["params"], new_w["params"]),
                            ("m", new_g["opt"]["m"], new_w["opt"]["m"]),
                            ("v", new_g["opt"]["v"], new_w["opt"]["v"])):
        err[part] = max(rel(a, b) for a, b in zip(leaves(got), leaves(want)))
        keep.update({f"{part}/{k}": full(v) for k, v in flat(got).items()})
    keep["loss"] = full(lg).reshape(1)
    keep.update({f"grads/{k}": full(g) for k, g in zip(flat(p), gg)})
    out["placed"] = sum(isinstance(g, DTensor) for g in gg) == len(gg)
    if torch.distributed.get_rank() == 0:
        np.savez(f"{DIR}/{name}.port.npz",
                 **{k.replace("/", "__"): v.numpy() for k, v in keep.items()})
    return {"err": err, **out}


def main(rank, world):
    out = {}
    for name, (arch, kw) in CASES.items():
        shape, names, kw, extra = layout(kw)
        mesh = make_mesh(shape, names, device_type="cpu")
        rules = with_axis_sizes({**(multipod(PROD_RULES) if "pod" in names
                                    else PROD_RULES), **extra["rules"]},
                                mesh)
        out[name] = one(name, arch, kw, mesh, rules, extra)
    return out
"""

# the reference: jax.jit(..., in_shardings=...) on a (2, 2) host mesh
JAX = COMMON + """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config, reduced
from repro.launch import serve, train
from repro.launch.mesh import make_mesh
from repro.models.common import PROD_RULES, multipod, with_axis_sizes
from repro.models.transformer import Model
from repro.optim.optimizers import AdamW, cosine_schedule

DIR = sys.argv[2]
for name, (arch, kw) in CASES.items():
    shape, names, kw, extra = layout(kw)
    mesh = make_mesh(shape, names)
    rules = with_axis_sizes({**(multipod(PROD_RULES) if "pod" in names
                                else PROD_RULES), **extra["rules"]}, mesh)
    cfg = reduced(get_config(arch)).replace(dtype=jnp.float32,
                                            **{"remat": False, **kw})
    if extra["int8"]:
        cfg = cfg.replace(cache_dtype=jnp.int8)
    data = np.load(f"{DIR}/{name}.npz")
    params = nested({k[2:]: jnp.asarray(data[k]) for k in data.files
                     if k.startswith("p/")})
    batch = {"tokens": jnp.asarray(data["tokens"]),
             **{k: jnp.asarray(data[k]) for k in FRONT_ENDS
                if k in data.files}}
    model = Model(cfg)
    opt = AdamW(schedule=cosine_schedule(1e-2, 2, 10))
    sh = train.make_state_shardings(model, opt, rules, mesh)
    batch_ns = {k: NamedSharding(mesh, P(rules["batch"],
                                         *[None] * (v.ndim - 1)))
                for k, v in batch.items()}
    keep = {}
    with mesh:
        if not cfg.remat:
            # a case that lays its cache out names it by the reference's
            # dry run's _cache_pspecs (imported after the mesh: that module
            # sets XLA_FLAGS)
            laid = {}
            if extra["rules"]:
                from repro.launch.dryrun import _cache_pspecs
                cache_ns = jax.tree_util.tree_map(
                    lambda p: NamedSharding(mesh, p), _cache_pspecs(
                        model, model.make_cache(extra["batch"], max_len(
                            cfg, extra), abstract=True), rules),
                    is_leaf=lambda x: isinstance(x, P))
                laid = {"prefill": {"out_shardings": (None, cache_ns)},
                        "decode": {"in_shardings": (
                            sh["params"], batch_ns["tokens"], cache_ns),
                            "out_shardings": (None, cache_ns)}}
            prefill = jax.jit(serve.make_prefill_step(model, rules,
                                                      max_len(cfg, extra)),
                              in_shardings=(sh["params"], batch_ns),
                              **laid.get("prefill", {}))
            logits, cache = prefill(params, batch)
            keep["prefill"] = logits
            tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
            decode = jax.jit(lambda p, t, c: model.decode_step(p, t, c,
                                                               rules),
                             **laid.get("decode", {}))
            for i in range(DECODE):
                lg, cache = decode(params, tok, cache)
                keep[f"decode{i}"] = lg
                tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
        state = {"params": params, "opt": opt.init(params)}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda q: model.loss(q, batch, rules)[0]),
            in_shardings=(sh["params"],))(params)
        keep["loss"] = jnp.reshape(loss, (1,))
        keep.update({f"grads/{k}": v for k, v in flat(grads).items()})
        step = jax.jit(train.make_train_step(model, opt, rules),
                       in_shardings=(sh, batch_ns))
        new, _ = step(state, batch)
        keep.update({f"params/{k}": v for k, v in flat(new["params"]).items()})
        keep.update({f"m/{k}": v for k, v in flat(new["opt"]["m"]).items()})
        keep.update({f"v/{k}": v for k, v in flat(new["opt"]["v"]).items()})
    np.savez(f"{DIR}/{name}.jax.npz",
             **{k.replace("/", "__"): np.asarray(v) for k, v in keep.items()})
print("JAX done")
"""


# a case's keys besides its config changes (``layout``)
CASE_KEYS = ("mesh", "rules", "batch", "max_len", "int8")


def _jcfg(arch, kw):
    import jax.numpy as jnp
    kw = {k: v for k, v in kw.items() if k not in CASE_KEYS}
    return jreduced(jget_config(arch)).replace(dtype=jnp.float32,
                                               **{"remat": False, **kw})


def run_cases(tmp, cases: dict, timeout: float = 240) -> list:
    """Both routes of the port over 4 ranks and the reference's jitted
    steps on ``cases`` (name -> (arch, config changes)), from the same
    weights and tokens, written under ``tmp``; returns each rank's
    results."""
    for name, (arch, kw) in cases.items():
        jcfg = _jcfg(arch, kw)
        params = numpy_params(jcfg)
        rng = np.random.default_rng(1)
        batch = kw.get("batch", BATCH)
        tokens = rng.integers(0, jcfg.vocab_size, (batch, SEQ),
                              dtype=np.int32)
        # whisper's frames and pixtral's patches, as the stub front ends
        # give them (std 0.02)
        front = {k: (rng.standard_normal((batch, n, jcfg.d_model)) * 0.02
                     ).astype(np.float32)
                 for k, n in (("frames", jcfg.encoder_seq),
                              ("patches", jcfg.n_patches)) if n}

        def flat(tree, prefix="p"):
            if isinstance(tree, dict):
                return {k2: v2 for k in tree
                        for k2, v2 in flat(tree[k], f"{prefix}/{k}").items()}
            return {prefix: tree}
        np.savez(tmp / f"{name}.npz", tokens=tokens, **front, **flat(params))
    encoded = json.dumps(cases)
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX, encoded, str(tmp)], cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=env(XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    try:
        ranks = run_ranks(PORT, 4, tmp, timeout=timeout, CASE_DIR=str(tmp),
                          CASES=encoded)
        out, err = jax_run.communicate(timeout=timeout)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.communicate()
    assert jax_run.returncode == 0 and "JAX done" in out, err[-3000:]
    return ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both routes of the port over 4 ranks and the reference's jitted
    steps, from the same weights and tokens."""
    tmp = tmp_path_factory.mktemp("partitioned")
    return tmp, run_cases(tmp, CASES)


def _load(path):
    with np.load(path) as data:
        return {k.replace("__", "/"): data[k] for k in data.files}


def hold_unpartitioned(ranks, name, limits=LIMITS):
    """Every rank's partitioned results of ``name`` within ``limits`` of
    its unpartitioned route's, its gradients placed, its tokens equal."""
    for r in ranks:
        got = r[name]
        for what, limit in limits.items():
            if what in got["err"]:
                assert got["err"][what] <= limit, (what, got["err"])
        assert got["placed"]
        if "tokens_equal" in got:
            assert got["tokens_equal"]


def hold_jax(tmp, name, limits=LIMITS):
    """Rank 0's gathered results of ``name`` within ``limits`` of the
    reference's jitted sharded steps."""
    port, ref = _load(tmp / f"{name}.port.npz"), _load(tmp / f"{name}.jax.npz")
    assert sorted(port) == sorted(ref)
    for key, want in ref.items():
        got = port[key].astype(np.float64)
        want = want.astype(np.float64)
        what = key.split("/")[0]
        what = "decode" if what.startswith("decode") else what
        if what == "loss":
            assert abs(got[0] - want[0]) <= limits["loss"] * abs(want[0]), key
            continue
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= limits[what], (key, err)


@pytest.mark.parametrize("name", CASES)
def test_partitioned_equals_unpartitioned(runs, name):
    _, ranks = runs
    hold_unpartitioned(ranks, name)
    assert ("prefill" in ranks[0][name]["err"]) == (name != "qwen3_remat")


@pytest.mark.parametrize("name", CASES)
def test_partitioned_equals_the_jax_sharded_step(runs, name):
    tmp, _ = runs
    hold_jax(tmp, name)


def test_vocab_stays_split(runs):
    """Qwen3's logits are laid out on the vocabulary split and its step
    never gathers a logits-sized tensor with the whole vocabulary."""
    _, ranks = runs
    for r in ranks:
        assert r["qwen3"]["logits_local"] == [BATCH // 2, 512 // 2]
        assert r["qwen3"]["logits_pl"] == ["S(0)", "S(1)"]
        assert r["qwen3"]["whole_vocab_collectives"] == 0
        # SmolLM's 503 do not divide 2: whole on every rank
        assert r["smollm"]["logits_local"] == [BATCH // 2, 503]


OUTSIDE = """
import json
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, distribute_tensor
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import PROD_RULES, with_axis_sizes
from repro_torch.models.transformer import Model

out = {}
with fake_world(False):
    pass
dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                        world_size=4)
mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
rules = with_axis_sizes(PROD_RULES, mesh)
for arch in ("granite-moe-1b-a400m", "llama4-maverick-400b-a17b",
             "mamba2-130m", "recurrentgemma-9b", "whisper-tiny",
             "pixtral-12b", "qwen3-0.6b"):
    try:
        Model(reduced(get_config(arch)),
              impl=ops.partitioned(None, mesh, rules))
        out[arch] = "built"
    except NotImplementedError as e:
        out[arch] = str(e)
a = distribute_tensor(torch.ones(4, 4), mesh, [Replicate(), Replicate()])
for name, call in (("matmul", lambda: ops.matmul(a, a)),
                   ("fused_add_rmsnorm",
                    lambda: ops.fused_add_rmsnorm(a, a, torch.ones(4)))):
    try:
        call()
        out[name] = "ran"
    except TypeError as e:
        out[name] = str(e)
dist.destroy_process_group()
print("OUT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def outside():
    res = subprocess.run([sys.executable, "-c", OUTSIDE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=env())
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("OUT ")]
    assert lines, res.stdout[-2000:] + res.stderr[-3000:]
    return json.loads(lines[-1][4:])


@pytest.mark.parametrize("arch", ["whisper-tiny", "pixtral-12b"])
def test_a_front_end_config_builds_on_a_mesh(outside, arch):
    """whisper-tiny (its encoder, cross-attention and learned positions)
    and pixtral-12b (its patch prefix) on ``DTensor``s,
    ``tests/test_torch_partitioned_frontends.py``."""
    assert outside[arch] == "built"


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b"])
def test_a_recurrent_config_builds_on_a_mesh(outside, arch):
    """mamba2-130m and recurrentgemma-9b (the SSD and RG-LRU mixers on
    ``DTensor``s, ``tests/test_torch_partitioned_ssm.py`` and
    ``tests/test_torch_partitioned_rglru.py``) are in the slice."""
    assert outside[arch] == "built"


def test_an_attention_decoder_builds_on_a_mesh(outside):
    assert outside["qwen3-0.6b"] == "built"


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "llama4-maverick-400b-a17b"])
def test_a_moe_config_builds_on_a_mesh(outside, arch):
    """granite-moe-1b and llama4-maverick (MoE with the experts on
    ``data``, ``tests/test_torch_partitioned_moe.py``) are in the
    slice."""
    assert outside[arch] == "built"


@pytest.mark.parametrize("kernel", ["matmul", "fused_add_rmsnorm"])
def test_a_dtensor_reaching_a_kernel_raises(outside, kernel):
    assert "DTensor" in outside[kernel] and "partitioned" in outside[kernel]

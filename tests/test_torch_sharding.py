"""The port's sharding rules (``repro_torch.models.common``: ``spec``,
``param_specs``, ``placements``, ``shard``), meshes
(``repro_torch.launch.mesh``) and state shardings
(``launch.train.make_state_shardings``, the optimizers' ``state_specs``)
against the JAX package's:

* the five tests of ``tests/test_sharding_rules.py`` on the port;
* ``Model.specs`` of all ten configs at full size, under ``PROD_RULES``
  and ``multipod`` sized {pod 2, data 16, model 16}, equal to the JAX
  ``Model.specs`` leaf by leaf as tuples, and the state specs likewise;
* ``placements``: a tuple axis shards its dimension on each of its mesh
  dimensions, in mesh order;
* on the ``fake`` backend (one process, world 256 and 512): the
  production meshes build, every leaf of every config placed by
  ``make_state_shardings`` has local shape = shape / axis product, and
  a mesh whose size is not the world's raises;
* over one ``gloo`` rank, a reduced model's logits with ``PROD_RULES``
  sized to a (1, 1) mesh equal the unruled logits bit for bit: the
  model's tensors are plain, on which ``shard`` returns its input, so
  this holds that rules change nothing there (``shard`` on DTensors is
  held by the four-rank test below);
* over 4 ``gloo`` ranks on a (2, 2) mesh: a reduced SmolLM's parameters
  and AdamW state placed by ``make_state_shardings``, one
  ``AdamW.update`` on the DTensors equal to the unsharded update within
  1e-6 once gathered, and ``shard`` redistributing an activation.
"""
import subprocess
import sys
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from test_torch_ranks import ROOT, env, run_ranks  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import common as JCOM  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402
from repro.optim.optimizers import AdamW as JAdamW  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.models.common import (PROD_RULES, ParamDef,  # noqa: E402
                                       PartitionSpec as P, multipod,
                                       param_specs, placements, spec,
                                       with_axis_sizes)
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.optim.optimizers import (SGDM, AdamW,  # noqa: E402
                                          constant_schedule)

SIZES = {"_axis_sizes": {"pod": 2, "data": 16, "model": 16}}


def rules(**extra):
    r = dict(PROD_RULES)
    r.update(SIZES)
    r.update(extra)
    return r


# ---- tests/test_sharding_rules.py on the port --------------------------------

def test_divisibility_fallback():
    r = rules()
    # 5 kv heads cannot split a 16-way axis -> unsharded
    assert spec(r, "batch", "seq", "kv_heads", shape=(256, 128, 5)) \
        == P("data", None, None)
    # 16 kv heads can
    assert spec(r, "batch", "seq", "kv_heads", shape=(256, 128, 16)) \
        == P("data", None, "model")


def test_duplicate_axis_dropped():
    r = rules(cache_seq="model")
    # cache_seq and cache_heads both resolve to 'model': first dim wins
    s = spec(r, "batch", "cache_seq", "cache_heads", None,
             shape=(128, 32768, 16, 128))
    assert s == P("data", "model", None, None)


def test_tuple_axis_divisibility():
    r = multipod(rules())
    # batch = ('pod','data') needs divisibility by 32
    assert spec(r, "batch", shape=(256,)) == P(("pod", "data"))
    assert spec(r, "batch", shape=(24,)) == P(None)


def test_param_specs_respect_shape():
    defs = {"wk": ParamDef((960, 5, 64), ("embed", "kv_heads", None))}
    specs = param_specs(defs, rules())
    assert specs["wk"] == P("data", None, None)
    defs2 = {"wk": ParamDef((1024, 16, 64), ("embed", "kv_heads", None))}
    assert param_specs(defs2, rules())["wk"] == P("data", "model", None)


def test_no_rules_means_replicated():
    assert spec(None, "batch", "seq") == P()
    defs = {"w": ParamDef((8, 8), ("embed", "ff"))}
    assert param_specs(defs, None)["w"] == P()


# ---- every config at full size against the JAX package ------------------------

def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("pods", [False, True], ids=["prod", "multipod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax_for_every_config(arch, pods):
    port_rules, jax_rules = rules(), dict(JCOM.PROD_RULES, **SIZES)
    if pods:
        port_rules, jax_rules = multipod(port_rules), JCOM.multipod(jax_rules)
    got = dict(_flat(Model(get_config(arch)).specs(port_rules)))
    want = dict(_flat(JModel(jget_config(arch)).specs(jax_rules)))
    assert list(got) == list(want)
    for key in got:
        assert type(got[key]) is P
        assert tuple(got[key]) == tuple(want[key]), key
    sharded = sum(any(e is not None for e in s) for s in got.values())
    assert sharded > 0
    # the optimizers' state mirrors the parameters
    ost = AdamW(schedule=constant_schedule(1.0)).state_specs(got)
    jost = JAdamW(schedule=lambda s: 1.0).state_specs(want)
    assert ost["m"] is got and ost["v"] is got
    assert tuple(ost["step"]) == tuple(jost["step"]) == ()


def test_sgdm_state_specs():
    pspecs = {"w": P("data", None)}
    got = SGDM(schedule=constant_schedule(1.0)).state_specs(pspecs)
    assert got == {"mom": pspecs, "step": P()}


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                           shape=(2, 16, 16))
    assert placements(P(("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert placements(P(None, "data"), mesh) == [Replicate(), Shard(1),
                                                 Replicate()]
    assert placements(P(), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="pod"):
        placements(P("pod"), SimpleNamespace(mesh_dim_names=("data",),
                                             shape=(4,)))
    assert with_axis_sizes(PROD_RULES, mesh)["_axis_sizes"] == {
        "pod": 2, "data": 16, "model": 16}


# ---- the fake backend: production meshes in one process ----------------------

FAKE = """
import json, math, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.train import make_state_shardings
from repro_torch.models.common import (PROD_RULES, multipod, tree_map,
                                       with_axis_sizes)
from repro_torch.models.transformer import Model
from repro_torch.optim.optimizers import AdamW, constant_schedule

out = {}
opt = AdamW(schedule=constant_schedule(1.0))
for world, pods in ((256, False), (512, True)):
    dist.init_process_group("fake", store=FakeStore(), rank=3,
                            world_size=world)
    for wrong in (not pods,):
        try:
            make_production_mesh(multi_pod=wrong, device_type="cpu")
            out[f"wrong_{world}"] = "built"
        except ValueError as e:
            out[f"wrong_{world}"] = str(e)
    try:
        make_mesh((4, 4), ("data", "model"), device_type="cpu")
        out[f"small_{world}"] = "built"
    except ValueError as e:
        out[f"small_{world}"] = str(e)
    mesh = make_production_mesh(multi_pod=pods, device_type="cpu")
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    rules = with_axis_sizes(multipod(PROD_RULES) if pods else PROD_RULES,
                            mesh)
    leaves = bad = 0
    for arch in ARCHS:
        model = Model(get_config(arch))
        pspecs = model.specs(rules)
        shardings = make_state_shardings(model, opt, rules, mesh)
        flat = []
        tree_map(flat.append, model.abstract())
        specs, pairs = [], []
        tree_map(specs.append, pspecs)
        tree_map(pairs.append, shardings["params"])
        mspecs = []
        tree_map(mspecs.append, shardings["opt"]["m"])
        assert len(mspecs) == len(pairs)
        for leaf, s, (m, pl) in zip(flat, specs, pairs):
            d = distribute_tensor(torch.empty(leaf.shape, device="meta"),
                                  m, pl, src_data_rank=None)
            want = tuple(
                n // (math.prod(sizes[a] for a in e) if isinstance(e, tuple)
                      else sizes.get(e, 1) if e else 1)
                for n, e in zip(leaf.shape, tuple(s) + (None,) * (
                    len(leaf.shape) - len(s))))
            leaves += 1
            bad += tuple(d.to_local().shape) != want
    out[f"mesh_{world}"] = [list(mesh.mesh_dim_names), list(mesh.shape)]
    out[f"leaves_{world}"], out[f"bad_{world}"] = leaves, bad
    dist.destroy_process_group()
print("FAKE " + json.dumps(out))
"""


def test_production_meshes_on_the_fake_backend():
    res = subprocess.run([sys.executable, "-c", FAKE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=env())
    import json
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("FAKE ")]
    assert lines, res.stdout + res.stderr
    got = json.loads(lines[-1][len("FAKE "):])
    assert got["mesh_256"] == [["data", "model"], [16, 16]]
    assert got["mesh_512"] == [["pod", "data", "model"], [2, 16, 16]]
    for world in (256, 512):
        assert got[f"leaves_{world}"] > 200 and got[f"bad_{world}"] == 0
        assert f"world size {world}" in got[f"wrong_{world}"]
        assert f"world size {world}" in got[f"small_{world}"]


# ---- one rank: the ruled forward is the unruled one ---------------------------

ONE = """
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import PROD_RULES, with_axis_sizes
from repro_torch.models.frontends import synth_frontend_inputs
from repro_torch.models.transformer import Model


def main(rank, world):
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    rules = with_axis_sizes(PROD_RULES, mesh)
    out = {}
    for arch in ("qwen3-0.6b", "llama4-maverick-400b-a17b", "whisper-tiny"):
        cfg = reduced(get_config(arch)).replace(dtype=torch.float32)
        model = Model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        tokens = torch.randint(0, cfg.vocab_size, (2, 10),
                               generator=torch.Generator().manual_seed(1))
        extras = synth_frontend_inputs(
            cfg, 2, torch.Generator().manual_seed(2), device="cpu")
        a = model.forward(params, tokens, None, **extras)[0]
        b = model.forward(params, tokens, rules, **extras)[0]
        out[arch] = [list(a.shape), bool(torch.equal(a, b))]
    return out
"""


def test_forward_with_rules_on_a_one_rank_mesh_is_bit_equal(tmp_path):
    """Rules on the model's plain tensors change nothing: no layout is
    placed here, the four-rank test places one."""
    (got,) = run_ranks(ONE, 1, tmp_path)
    for arch, (shape, equal) in got.items():
        assert shape[:2] == [2, 10] and equal, arch


# ---- four ranks: AdamW on the placed state ------------------------------------

FOUR = """
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import make_state_shardings, trainable
from repro_torch.models.common import (PROD_RULES, shard, tree_map,
                                       with_axis_sizes)
from repro_torch.models.transformer import Model
from repro_torch.optim.optimizers import AdamW, cosine_schedule


def main(rank, world):
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    rules = with_axis_sizes(PROD_RULES, mesh)
    cfg = reduced(get_config("smollm-360m")).replace(dtype=torch.float32)
    model = Model(cfg)
    opt = AdamW(schedule=cosine_schedule(1e-2, 2, 10))
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    p = trainable(params)
    loss, _ = model.loss(p, {"tokens": tokens})
    gs = iter(torch.autograd.grad(loss, [l for l in _leaves(p)]))
    grads = tree_map(lambda _: next(gs), p)
    # a state one step in, so that the moments are not zeros
    state = opt.init(params)
    _, state, _ = opt.update(grads, state, params)
    want_p, want_s, want_m = opt.update(grads, state, params)

    sh = make_state_shardings(model, opt, rules, mesh)
    place = lambda t, pair: distribute_tensor(t, *pair)
    dparams = _map2(place, params, sh["params"])
    dgrads = _map2(place, grads, sh["params"])
    dstate = {"m": _map2(place, state["m"], sh["opt"]["m"]),
              "v": _map2(place, state["v"], sh["opt"]["v"]),
              "step": state["step"]}
    sharded = sum(any(isinstance(pl, Shard) for pl in pair[1])
                  for pair in _leaves(sh["params"]))
    got_p, got_s, got_m = opt.update(dgrads, dstate, dparams)
    worst = 0.0
    for name, got, want in (("p", got_p, want_p), ("m", got_s["m"],
                            want_s["m"]), ("v", got_s["v"], want_s["v"])):
        for g, w in zip(_leaves(got), _leaves(want)):
            assert isinstance(g, DTensor)
            full = g.full_tensor()
            worst = max(worst, float(((full - w).abs()
                                      / w.abs().clamp_min(1e-30)).max()))
    x = distribute_tensor(torch.arange(4 * 6 * 8.).reshape(4, 6, 8), mesh,
                          [Replicate(), Replicate()])
    y = shard(x, rules, "batch", "seq", "act_embed")
    return {"worst": worst, "sharded": sharded,
            "leaves": len(_leaves(sh["params"])),
            "gnorm": [float(got_m["grad_norm"].full_tensor()),
                      float(want_m["grad_norm"])],
            "shard": [str(pl) for pl in y.placements],
            "shard_equal": bool(torch.equal(y.full_tensor(),
                                            x.full_tensor()))}


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _map2(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _map2(fn, tree[k], other[k]) for k in tree}
    return fn(tree, other)
"""


def test_adamw_on_state_placed_by_make_state_shardings(tmp_path):
    got = run_ranks(FOUR, 4, tmp_path)
    for r in got:
        assert r["worst"] <= 1e-6, r
        assert r["sharded"] >= 5 and r["leaves"] > r["sharded"]
        assert r["gnorm"][0] == pytest.approx(r["gnorm"][1], rel=1e-6)
        assert r["shard"] == ["S(0)", "R"]
        assert r["shard_equal"]

"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``), on the CPU:

* on the ``fake`` backend, in a subprocess (one default process group a
  process; world 256, then 512): ``lower_cell`` of two reduced configs
  (qwen3-0.6b, granite-moe-1b: reduced in width and depth, the cell's
  adjustments kept) for ``train_4k``, ``prefill_32k`` and ``decode_32k``
  on both production meshes gives the reference's record keys (less the
  XLA-only ``xla_*_body_once``),
  an ``argument_bytes`` equal to the sum of every input leaf's local
  shard (shape over the product of its mesh axes, reckoned here from the
  specs), the walker's FLOPs and bytes in the roofline, and ``main``
  writes a skipped cell and exits non-zero on a failing one;
* ``_cache_pspecs`` equal to the JAX package's for every config's decode
  cache (a KV cache, int8 with scales, SSM and RG-LRU states, whisper's
  cross-attention cache) under both meshes' rules;
* ``optimized_overrides`` equal to the JAX package's for all 40 cells,
  and a skipped cell's record equal to the reference's;
* the helpers of ``chip_smoke.py``'s phase 22: ``chunked_train_launches``
  against the calls a counting ``impl`` sees in a chunked-CE step;
  the peak of ``launch.program.StepReader`` (which the phase reads too)
  on storages kept by autograd, on copies made under inference mode and
  inside ``einsum``, and on the softmax backward's CUDA temporary;
  ``launch.program.kernel_shaped``'s GEMM allocating as the wrapper;
  ``grouped_plain`` and ``kv_group``
  against the plain attention; ``walked_and_counted``'s two counts
  equal; ``dry_walks``' JSON (what ``DryWalks``' process writes) read
  back equal to the walks made in place; the whole phase
  (``dryrun_slice``) at reduced size with the CUDA calls stubbed.

Every comparison is exact but the attention's (1e-6, float32) and
the rehearsal's routes (1e-2).
"""
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from test_torch_ranks import ROOT, env  # noqa: E402
from test_torch_serve import _smoke  # noqa: E402
from test_torch_train import Opaque  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import shapes as JSH  # noqa: E402
from repro.models import common as JCOM  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402

from repro_torch.configs import ARCHS, get_config, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun, program, shapes, train  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

SMOKE = _smoke()


@pytest.fixture(scope="module")
def jdryrun():
    """The JAX package's dry-run module, imported without letting its
    ``XLA_FLAGS`` line (512 host devices, set at import) reach the
    environment of later subprocesses."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as module
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return module


FAKE = r"""
import dataclasses, json, math, sys, tempfile
import torch
from repro_torch.configs import get_config, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.shapes import SHAPES, batch_input_specs, adjust_config
from repro_torch.models.common import tree_map
from repro_torch.models.transformer import Model

def resized(arch):
    full, small = get_config(arch), reduced(get_config(arch))
    return {f.name: getattr(small, f.name) for f in dataclasses.fields(small)
            if getattr(small, f.name) != getattr(full, f.name)}

def leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out

def local(shape, pspec, sizes):
    n = 1
    for i, d in enumerate(shape):
        e = pspec[i] if i < len(pspec) else None
        axes = e if isinstance(e, tuple) else (e,)
        n *= d // math.prod(sizes[a] for a in axes if a is not None)
    return n

out = {}
for multi in (False, True):
    with dryrun.fake_world(multi):
        for arch in ("qwen3-0.6b", "granite-moe-1b-a400m"):
            for shape in ("train_4k", "prefill_32k", "decode_32k"):
                rec, cost = dryrun.lower_cell(arch, shape, multi,
                                              cfg_override=resized(arch))
                spec = SHAPES[shape]
                cfg = adjust_config(get_config(arch), spec).replace(
                    **resized(arch))
                mesh_sizes = ({"pod": 2} if multi else {}) | {
                    "data": 16, "model": 16}
                rules = dryrun.cell_rules(spec, multi, 16)
                rules["_axis_sizes"] = mesh_sizes
                model = Model(cfg)
                size = {torch.bfloat16: 2, torch.float32: 4,
                        torch.int32: 4, torch.int8: 1}
                want = 0
                pspecs = leaves(model.specs(rules))
                params = leaves(model.abstract())
                for s, p in zip(params, pspecs):
                    want += local(s.shape, p, mesh_sizes) * size[s.dtype]
                if spec.kind == "train":
                    want += 2 * sum(local(s.shape, p, mesh_sizes) * 4
                                    for s, p in zip(params, pspecs)) + 4
                specs = batch_input_specs(cfg, spec)
                for name, s in specs.items():
                    if spec.kind == "decode" and name != "tokens":
                        continue
                    p = (rules.get("batch"),) + (None,) * (len(s.shape) - 1)
                    want += local(s.shape, p, mesh_sizes) * size[s.dtype]
                if spec.kind == "decode":
                    cache = model.make_cache(spec.global_batch, spec.seq,
                                             abstract=True)
                    cps = dryrun._cache_pspecs(model, cache, rules)
                    for s, p in zip(leaves(cache), leaves(cps)):
                        want += local(s.shape, p, mesh_sizes) * size[s.dtype]
                out[f"{arch}/{shape}/{rec['mesh']}"] = {
                    "keys": sorted(rec), "memory": sorted(rec["memory"]),
                    "roofline": sorted(rec["roofline"]),
                    "status": rec["status"], "chips": rec["chips"],
                    "argument": rec["memory"]["argument_bytes"],
                    "want_argument": want,
                    "output": rec["memory"]["output_bytes"],
                    "flops": rec["roofline"]["flops"],
                    "cost": [cost.flops, cost.bytes, cost.gemm_flops],
                    "hbm": rec["roofline"]["hbm_bytes"],
                    "bound": rec["roofline"]["bound"],
                    "t_collective": rec["roofline"]["t_collective_s"],
                    "temp": rec["memory"]["temp_bytes"],
                    "alias": rec["memory"]["alias_bytes"],
                    "by_kind": rec["roofline"]["collective_by_kind"],
                    "coll": rec["roofline"]["collective_bytes"],
                    "per_device": rec["roofline"].get(
                        "collective_bytes_per_device")}
with tempfile.TemporaryDirectory() as tmp:
    dryrun.main(["--arch", "qwen3-0.6b", "--shape", "long_500k", "--out", tmp])
    out["skipped"] = json.loads(open(
        f"{tmp}/qwen3-0.6b.long_500k.16x16.json").read())
    try:
        dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k",
                     "--out", tmp])
        out["failing"] = "returned"
    except SystemExit as e:
        out["failing"] = str(e.code)
        out["error"] = json.loads(open(
            f"{tmp}/no-such-arch.train_4k.16x16.json").read())["status"]
print("FAKE " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake():
    res = subprocess.run([sys.executable, "-c", FAKE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=env())
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("FAKE ")]
    assert lines, res.stdout[-3000:] + res.stderr[-3000:]
    return json.loads(lines[-1][len("FAKE "):])


CELLS = [f"{a}/{s}/{m}" for a in ("qwen3-0.6b", "granite-moe-1b-a400m")
         for s in ("train_4k", "prefill_32k", "decode_32k")
         for m in ("16x16", "2x16x16")]

# the reference's record (launch/dryrun.py) and roofline (roofline.py)
REF_KEYS = ["arch", "chips", "compile_us", "memory", "mesh",
            "n_params_active", "n_params_total", "roofline", "shape",
            "status"]
REF_MEMORY = ["alias_bytes", "argument_bytes", "output_bytes", "temp_bytes"]
REF_ROOFLINE = ["bound", "chips", "collective_by_kind", "collective_bytes",
                "flops", "hbm_bytes", "model_flops", "model_flops_ratio",
                "roofline_fraction", "step_time_s", "t_collective_s",
                "t_compute_s", "t_memory_s"]


@pytest.mark.parametrize("cell", CELLS)
def test_lower_cell_on_the_fake_backend(fake, cell):
    """Qwen3's and granite's (MoE) cells are on the partitioned route:
    their temp, alias and collective terms are read from rank 0's
    step."""
    got = fake[cell]
    assert got["status"] == "ok"
    chips = 512 if cell.endswith("2x16x16") else 256
    assert got["chips"] == chips
    assert got["keys"] == REF_KEYS
    assert got["argument"] == got["want_argument"]
    assert got["output"] > 0
    assert got["flops"] == got["cost"][0] and got["hbm"] == got["cost"][1]
    assert got["memory"] == sorted(REF_MEMORY)
    assert got["roofline"] == sorted(
        REF_ROOFLINE + ["collective_bytes_per_device", "gemm_flops"])
    assert got["temp"] > 0 and got["per_device"] > 0
    assert got["coll"] == chips * got["per_device"]
    assert sum(got["by_kind"].values()) == got["coll"]
    assert got["t_collective"] == pytest.approx(
        got["per_device"] / 450e9, rel=1e-12)
    # the decode cache is written in place; nothing else is
    assert (got["alias"] > 0) == ("decode" in cell)
    assert got["bound"] in ("compute", "memory", "collective")


PARTITIONED = r"""
import json, math, tempfile
import torch
from torch.distributed.tensor import Shard, distribute_tensor
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, program
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.train import make_state_shardings
from repro_torch.models.common import (PROD_RULES, placed_zeros,
                                       with_axis_sizes)
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamW, constant_schedule

out = {}
with tempfile.TemporaryDirectory() as tmp:
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        dryrun.main(["--arch", "qwen3-0.6b", "--shape", shape, "--out", tmp])
        out[shape] = json.loads(open(
            f"{tmp}/qwen3-0.6b.{shape}.16x16.json").read())
    dryrun.main(["--arch", "recurrentgemma-9b", "--shape", "long_500k",
                 "--out", tmp])
    out["recurrentgemma"] = json.loads(open(
        f"{tmp}/recurrentgemma-9b.long_500k.16x16.json").read())

# one FSDP product alone: Qwen3's MLP input weight, one layer of it
with dryrun.fake_world(False):
    mesh = make_production_mesh(device_type="cpu")
    rules = with_axis_sizes(PROD_RULES, mesh)
    model = Model(get_config("qwen3-0.6b"))
    mesh_, pl = make_state_shardings(
        model, AdamW(schedule=constant_schedule(1e-4)), rules,
        mesh)["params"]["blk0"]["mlp"]["wi"]
    leaf = distribute_tensor(torch.empty((28, 1024, 3072),
                                         dtype=torch.bfloat16,
                                         device="meta"),
                             mesh, pl, src_data_rank=None)
    local = list(leaf.to_local().shape[1:])
    w = placed_zeros((1024, 3072), torch.bfloat16, mesh,
                     [Shard(p.dim - 1) if isinstance(p, Shard) else p
                      for p in pl], "meta").requires_grad_()
    x = placed_zeros((32, 8, 1024), torch.bfloat16, mesh,
                     dryrun.placements(dryrun.P("data", None, None), mesh),
                     "meta")
    part = ops.partitioned(program.kernel_shaped(), mesh, rules)
    reader = program.StepReader()
    with reader:
        y = part.matmul(x, w)
        torch.autograd.grad(y.to_local().sum(), [w])
    out["fsdp"] = {"local": local, "calls": reader.calls,
                   "by_kind": reader.collectives,
                   "placements": [str(p) for p in pl]}
print("PART " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def partitioned():
    res = subprocess.run([sys.executable, "-c", PARTITIONED], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=env())
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("PART ")]
    assert lines, res.stdout[-3000:] + res.stderr[-3000:]
    return json.loads(lines[-1][len("PART "):])


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_qwen3_cells_read_the_partitioned_step(partitioned, shape):
    """``python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape S``
    at full size on the 16 x 16 mesh records the temp, alias and
    collective terms of rank 0's partitioned step."""
    rec = partitioned[shape]
    mem, roof = rec["memory"], rec["roofline"]
    assert "why" not in mem and "why" not in roof
    assert isinstance(mem["temp_bytes"], int) and mem["temp_bytes"] > 0
    assert isinstance(mem["alias_bytes"], int)
    # the decode cache, 28 layers x (k, v) of 8 rows x 32,768 x 8 KV
    # heads x 128 in bfloat16 (the KV heads whole: 8 do not divide 16)
    # plus the int32 positions; nothing else is written in place
    want_alias = 28 * 2 * 8 * 32768 * 8 * 128 * 2 + 28 * 4 \
        if shape == "decode_32k" else 0
    assert mem["alias_bytes"] == want_alias
    kinds = roof["collective_by_kind"]
    assert set(kinds) <= {"all-gather", "reduce-scatter", "all-reduce",
                          "all-to-all"} and kinds["all-gather"] > 0
    assert sum(kinds.values()) == roof["collective_bytes"] == \
        256 * roof["collective_bytes_per_device"]
    assert roof["t_collective_s"] == pytest.approx(
        roof["collective_bytes_per_device"] / 450e9, rel=1e-12)
    assert roof["step_time_s"] == max(roof["t_compute_s"],
                                      roof["t_memory_s"],
                                      roof["t_collective_s"])


def test_a_cell_outside_the_slice_keeps_none(partitioned):
    """recurrentgemma-9b's ``long_500k``, once outside the partitioned
    route, now reads it: batch 1 does not split over 16 data ranks, so
    its local attention's KV cache lies on ``cache_seq`` = ``data``
    (32,768 of 524,288 rows a rank, the one KV head whole) and the
    attention merges its partial softmaxes across ``data``.  The alias
    is that cache, in closed form: 12 attention layers' K and V (head_dim
    256, bfloat16) and positions, and 26 RG-LRU layers' states (4,096
    channels split 16 ways) and conv tails (3 x 4,096, whole), float32.
    (More such cells: ``tests/test_torch_dryrun_cache.py``.)"""
    rec = partitioned["recurrentgemma"]
    mem, roof = rec["memory"], rec["roofline"]
    assert "why" not in mem and "why" not in roof
    assert isinstance(mem["temp_bytes"], int) and mem["temp_bytes"] > 0
    cfg = get_config("recurrentgemma-9b")
    kinds = cfg.layer_kinds()
    assert (kinds.count("attn"), kinds.count("rglru")) == (12, 26)
    rows = 524288 // 16
    assert mem["alias_bytes"] == (
        12 * (2 * rows * cfg.hd * 2 + 4)
        + 26 * (cfg.rnn_width // 16 + 3 * cfg.rnn_width) * 4)
    assert roof["collective_by_kind"]["all-reduce"] > 0
    assert roof["t_collective_s"] == pytest.approx(
        roof["collective_bytes_per_device"] / 450e9, rel=1e-12)


def test_fsdp_product_collectives_have_the_closed_form(partitioned):
    """One column-parallel product of a weight laid out by
    ``make_state_shardings`` (``embed`` on ``data``, ``ff`` on
    ``model``): the forward all-gathers the weight over ``data``, the
    backward reduce-scatters its gradient back, in bfloat16; nothing
    else crosses."""
    got = partitioned["fsdp"]
    assert got["placements"] == ["S(1)", "S(2)"]
    d_local, f_local = got["local"]
    assert [d_local, f_local] == [1024 // 16, 3072 // 16]
    assert got["calls"] == [["all-gather", [16 * d_local, f_local]],
                            ["reduce-scatter", [d_local, f_local]]]
    assert got["by_kind"] == {"all-gather": 16 * d_local * f_local * 2,
                              "reduce-scatter": d_local * f_local * 2}


# The same reduced cells through the reference's dry-run parser and the
# port's read: Qwen3 reduced (vocabulary 512), in float32 (the CPU's XLA
# widens bfloat16 collectives to float32), on a (2, 2) ("data", "model")
# mesh; the cells cut to a global batch of 4 and 64 tokens, their rules
# and adjustments kept.
HLO_CELLS = {"train_4k": (4, 64), "prefill_32k": (4, 64),
             "decode_32k": (4, 64)}
HLO_KW = {"vocab_size": 512}

HLO_COMMON = r"""
import dataclasses, json, sys
cells, kw, arch = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]
"""

# the reference: jax.jit(in_shardings=...) of each cell's step on 4 forced
# host devices, its per-device HLO read by roofline.collective_bytes
HLO_JAX = HLO_COMMON + r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config, reduced
from repro.launch import roofline
from repro.launch.mesh import make_mesh
mesh = make_mesh((2, 2), ("data", "model"))   # before dryrun's XLA_FLAGS
from repro.launch.dryrun import _batch_shardings, _cache_pspecs, _tree_ns
from repro.launch.serve import make_prefill_step, make_serve_step
from repro.launch.shapes import (SHAPES, adjust_config, batch_input_specs,
                                 cell_rules)
from repro.launch.train import make_train_step
from repro.models.common import with_axis_sizes
from repro.models.transformer import Model
from repro.optim.optimizers import AdamW, constant_schedule
import re
COLLECTIVE = re.compile(r"(all-reduce|all-gather|reduce-scatter|"
                        r"all-to-all|collective-permute)(-start)?\(")

out = {}
for name, (b, s, *variant) in cells.items():
    variant = variant[0] if variant else {}
    shape = dataclasses.replace(SHAPES[variant.get("shape", name)],
                                global_batch=b, seq=s)
    cfg = adjust_config(reduced(get_config(arch)), shape).replace(
        dtype=jnp.float32, **kw)
    if variant.get("int8"):
        cfg = cfg.replace(cache_dtype=jnp.int8)
    rules = with_axis_sizes({**cell_rules(shape, False, 2),
                             **variant.get("rules", {})}, mesh)
    model = Model(cfg)
    params_abs, pspecs = model.abstract(), model.specs(rules)
    params_ns = _tree_ns(mesh, pspecs)
    specs = batch_input_specs(cfg, shape)
    batch_ns = _batch_shardings(mesh, rules, specs)
    with mesh:
        if shape.kind == "train":
            opt = AdamW(schedule=constant_schedule(1e-4))
            state_ns = {"params": params_ns,
                        "opt": _tree_ns(mesh, opt.state_specs(pspecs))}
            state_abs = {"params": params_abs,
                         "opt": jax.eval_shape(opt.init, params_abs)}
            lowered = jax.jit(make_train_step(model, opt, rules),
                              in_shardings=(state_ns, batch_ns),
                              out_shardings=(state_ns, None),
                              donate_argnums=(0,)).lower(state_abs, specs)
        elif shape.kind == "prefill":
            lowered = jax.jit(make_prefill_step(model, rules, s + 8),
                              in_shardings=(params_ns, batch_ns)).lower(
                params_abs, specs)
        else:
            cache_abs = model.make_cache(b, s, abstract=True)
            cache_ns = jax.tree_util.tree_map(
                lambda p: NamedSharding(mesh, p),
                _cache_pspecs(model, cache_abs, rules),
                is_leaf=lambda x: isinstance(x, P))
            lowered = jax.jit(make_serve_step(model, rules),
                              in_shardings=(params_ns, cache_ns,
                                            batch_ns["tokens"]),
                              out_shardings=(None, cache_ns),
                              donate_argnums=(1,)).lower(
                params_abs, cache_abs, specs["tokens"])
        hlo = lowered.compile().as_text()
    out[name] = roofline.collective_bytes(hlo)[1]
    # the MoE layer's: those inside the map over token blocks, a loop in
    # the layers' loop (two "while/body" in an op's name)
    moe = "\n".join(line for line in hlo.splitlines()
                    if not COLLECTIVE.search(line)
                    or line.count("while/body") >= 2)
    out[name + "/moe"] = roofline.collective_bytes(moe)[1]
print("HLO " + json.dumps(out))
"""

# the port: rank 0's partitioned step of each cell on a fake world of 4
HLO_PORT = HLO_COMMON + r"""
import torch
import torch.distributed as dist
from repro_torch.configs import get_config, reduced
from repro_torch.launch import dryrun, program
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shapes import SHAPES, adjust_config, cell_rules
from repro_torch.models.common import with_axis_sizes

dryrun._fake_backend()
dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                        world_size=4)
mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
out = {}
# the MoE layers' and the SSD and RG-LRU mixers' collectives: those
# issued inside apply_moe, apply_ssm and apply_rglru (the forward's and a
# recompute's; a backward's run outside them)
from repro_torch.models import moe as MOE, rglru as RG, ssm as SSM
inside = {"moe": {}, "ssm": {}, "rglru": {}}


def counted(module, fn_name, part):
    fn = getattr(module, fn_name)

    def wrapped(*args, **kwargs):
        reader = program.StepReader()
        with reader:
            res = fn(*args, **kwargs)
        for k, v in reader.collectives.items():
            inside[part][k] = inside[part].get(k, 0) + v
        return res
    setattr(module, fn_name, wrapped)


counted(MOE, "apply_moe", "moe")
counted(SSM, "apply_ssm", "ssm")
counted(RG, "apply_rglru", "rglru")
for name, (b, s, *variant) in cells.items():
    variant = variant[0] if variant else {}
    shape = dataclasses.replace(SHAPES[variant.get("shape", name)],
                                global_batch=b, seq=s)
    cfg = adjust_config(reduced(get_config(arch)), shape).replace(
        dtype=torch.float32, **kw)
    if variant.get("int8"):
        cfg = cfg.replace(cache_dtype=torch.int8)
    rules = with_axis_sizes({**cell_rules(shape, False, 2),
                             **variant.get("rules", {})}, mesh)
    step, inputs = program.local_program(cfg, shape.kind, b, s, mesh, rules)
    for part in inside.values():
        part.clear()
    out[name] = program.read_step(step, *inputs)["collective_by_kind"]
    for part, got in inside.items():
        out[f"{name}/{part}"] = dict(got)
dist.destroy_process_group()
print("HLO " + json.dumps(out))
"""


def hlo_collectives(cells, kw, arch="qwen3-0.6b"):
    """``(reference, port)``: each reduced cell's per-device collective
    bytes by kind, from the reference's HLO and from the port's read."""
    args = [json.dumps(cells), json.dumps(kw), arch]
    procs = [subprocess.Popen([sys.executable, "-c", script, *args],
                              cwd=ROOT, text=True, env=env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for script in (HLO_JAX, HLO_PORT)]
    got = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=600)
            lines = [ln for ln in out.splitlines() if ln.startswith("HLO ")]
            assert proc.returncode == 0 and lines, out[-2000:] + err[-3000:]
            got.append(json.loads(lines[-1][len("HLO "):]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return tuple(got)


@pytest.fixture(scope="module")
def against_hlo():
    """``(reference, port)`` of Qwen3's reduced cells."""
    return hlo_collectives(HLO_CELLS, HLO_KW)


@pytest.mark.parametrize("cell", sorted(HLO_CELLS))
def test_collectives_against_the_reference_hlo(against_hlo, cell):
    """The port's collective bytes of a cell against the reference's
    ``roofline.collective_bytes`` over the jitted step's per-device HLO,
    by kind.  Two differences are the compilers', not the programs':

    * the CPU's XLA forms no reduce-scatter: it all-reduces, then each
      device slices its part; the port's reduce-scatter over a group of
      2 is that all-reduce at half its output's bytes;
    * the embedding lookup: the port gathers its table's shard over
      ``data`` ((vocab / 2) x d in float32) and sums the looked-up rows
      over ``model``; the reference gathers the token ids over ``data``
      (batch x tokens int32), sums the rows, and lays them out again by
      an all-to-all and a collective-permute.

    With those, a prefill and a decode step move the same bytes of each
    kind.  The training step moves no more than the reference's: the
    reference gathers each weight again in the backward and all-reduces
    the weights' gradients whole, where the port keeps the forward's
    gathered weight (outside a remat group) and reduce-scatters."""
    ref, port = (side[cell] for side in against_hlo)
    batch, seq = HLO_CELLS[cell]
    kind = shapes.SHAPES[cell].kind
    cfg = reduced(get_config("qwen3-0.6b")).replace(**HLO_KW)
    table = cfg.vocab_size // 2 * cfg.d_model * 4
    token_ids = batch * (1 if kind == "decode" else seq) * 4
    assert set(port) <= {"all-gather", "all-reduce", "reduce-scatter"}
    assert set(ref) <= {"all-gather", "all-reduce", "all-to-all",
                        "collective-permute"}
    gathered = port["all-gather"] - table, ref["all-gather"] - token_ids
    reduced_ = (port["all-reduce"] + 2 * port.get("reduce-scatter", 0),
                ref["all-reduce"])
    if kind == "train":
        assert 0 < gathered[0] <= gathered[1]
        assert 0 < reduced_[0] <= reduced_[1]
    else:
        assert gathered[0] == gathered[1] > 0
        assert reduced_[0] == reduced_[1] > 0


def test_main_writes_skipped_cells_and_fails_on_errors(fake, jdryrun,
                                                        tmp_path):
    want = jdryrun.run_cell("qwen3-0.6b", "long_500k", False, tmp_path)
    assert fake["skipped"] == want
    assert fake["failing"] == "1 cells failed"
    assert fake["error"] == "error"


def test_skipped_record_equals_the_reference(jdryrun, tmp_path):
    skipped = [a for a in ARCHS
               if not shapes.cell_is_runnable(a, "long_500k")[0]]
    assert len(skipped) == 7
    for arch in skipped:
        got = dryrun.run_cell(arch, "long_500k", True, tmp_path / "port")
        want = jdryrun.run_cell(arch, "long_500k", True, tmp_path / "jax")
        assert got == want and got["status"] == "skipped"


def _rules_pair(multi_pod):
    sizes = ({"pod": 2} if multi_pod else {}) | {"data": 16, "model": 16}
    spec = shapes.SHAPES["decode_32k"]
    jspec = JSH.SHAPES["decode_32k"]
    rules = shapes.cell_rules(spec, multi_pod, 16)
    jrules = JSH.cell_rules(jspec, multi_pod, 16)
    rules["_axis_sizes"] = jrules["_axis_sizes"] = sizes
    return rules, jrules


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_equal_the_reference(jdryrun, arch, multi_pod):
    rules, jrules = _rules_pair(multi_pod)
    for int8 in (False, True):
        cfg, jcfg = get_config(arch), jget_config(arch)
        if int8:
            import jax.numpy as jnp
            cfg = cfg.replace(cache_dtype=torch.int8)
            jcfg = jcfg.replace(cache_dtype=jnp.int8)
        model, jmodel = Model(cfg), JModel(jcfg)
        got = dryrun._cache_pspecs(model, model.make_cache(
            128, 32768, abstract=True), rules)
        want = jdryrun._cache_pspecs(jmodel, jmodel.make_cache(
            128, 32768, abstract=True), jrules)
        flat = train.leaves(got)
        import jax
        jflat = jax.tree_util.tree_leaves(
            want, is_leaf=lambda x: isinstance(x, JCOM.P))
        assert [tuple(p) for p in flat] == [tuple(p) for p in jflat]


def test_optimized_overrides_equal_the_reference(jdryrun):
    for arch in ARCHS:
        for shape in shapes.SHAPES:
            rules, cfgo, flash = dryrun.optimized_overrides(arch, shape)
            jrules, jcfgo, jflash = jdryrun.optimized_overrides(arch, shape)
            assert (rules, flash) == (jrules, jflash)
            names = {k: (v.__name__ if hasattr(v, "__name__") else
                         str(v).replace("torch.", "")) for k, v in
                     cfgo.items()}
            jnames = {k: (v.__name__ if hasattr(v, "__name__") else str(v))
                      for k, v in jcfgo.items()}
            assert names == jnames


def test_period_and_depth_of_the_ten_configs():
    want = {"gemma3-27b": 6, "recurrentgemma-9b": 3,
            "llama4-maverick-400b-a17b": 2}
    for arch in ARCHS:
        assert dryrun.period(get_config(arch)) == want.get(arch, 1)


# ---- chip_smoke.py's phase 22 helpers ---------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_chunked_train_launches_equal_the_calls(remat):
    """Without remat, and under ``full`` as phase 22's ``train_4k``."""
    cfg = reduced(get_config("qwen3-0.6b")).replace(
        dtype=torch.float32, remat=remat, ce_chunk=8)
    seq = 33                  # 32 targets: 4 chunks of 8
    params = train.trainable(Model(cfg).init(
        torch.Generator().manual_seed(0)))
    tokens = torch.randint(0, cfg.vocab_size, (2, seq),
                           generator=torch.Generator().manual_seed(1))
    opaque = Opaque()
    model = Model(cfg, impl=ops.differentiable(opaque))
    loss, _ = model.loss(params, {"tokens": tokens})
    torch.autograd.grad(loss, train.leaves(params))
    assert opaque.n == SMOKE.chunked_train_launches(cfg, seq)
    assert SMOKE.chunked_train_launches(cfg.replace(ce_chunk=0), seq) == \
        SMOKE.train_launches(cfg)


def meta_peak_bytes(fn) -> int:
    """The most bytes ``fn()``'s ops hold at once (``StepReader``)."""
    reader = program.StepReader()
    with reader:
        fn()
    return reader.peak


def test_meta_peak_bytes_follows_storages():
    a = torch.empty(1000, 1000, device="meta", requires_grad=True)

    def kept():
        x = a * 2                 # freed at once
        y = x.exp()               # kept by autograd for exp's backward
        return (y * 3).sum()
    # x, y and y * 3 at once: 12 MB
    assert meta_peak_bytes(kept) == 3 * 4_000_000 + 4

    x = torch.empty(4096, 1024, dtype=torch.bfloat16, device="meta")

    @torch.inference_mode()
    def copies():
        # under inference mode aten.to reaches the mode undecomposed
        return x.to(torch.float32).to(torch.float64)
    assert meta_peak_bytes(copies) == 4096 * 1024 * (4 + 8)


def test_walked_and_counted_agree():
    cfg = reduced(get_config("granite-moe-1b-a400m"))
    cost, counted = SMOKE.walked_and_counted(cfg, "train", 2, 16)
    assert cost.gemm_flops == counted > 0
    assert math.isfinite(cost.bytes) and cost.bytes > 0


def test_phase_22_walks_survive_their_json(monkeypatch, tmp_path):
    """Phase 22's CPU part, as ``DryWalks``' process writes it
    (``dry_walks``: every cell's ``walk_cell``, as JSON): read back, the
    reckoning, the walker's ``Cost`` and the counted FLOPs equal
    ``dry_reckoning``'s and ``walked_and_counted``'s (reduced Qwen3, the
    cells cut to 32 tokens)."""
    import dataclasses
    import json as json_
    import repro_torch.configs as configs
    from repro_torch.launch import shapes as SH
    from repro_torch.launch.costmodel import Cost
    full = configs.get_config
    monkeypatch.setattr(configs, "get_config",
                        lambda arch: reduced(full(arch)))
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        monkeypatch.setitem(SH.SHAPES, name, dataclasses.replace(
            SH.SHAPES[name], seq=32))
    path = tmp_path / "walks.json"
    SMOKE.dry_walks(str(path))
    walks = json_.loads(path.read_text())
    assert sorted(walks) == sorted(name for name, _ in SMOKE.DRY_CELLS)
    for name, batch in SMOKE.DRY_CELLS:
        shape = SH.SHAPES[name]
        cfg = SH.adjust_config(reduced(full(SMOKE.DRY_ARCH)), shape)
        cost, counted = SMOKE.walked_and_counted(cfg, shape.kind, batch, 32)
        got = walks[name]
        assert Cost(**got["cost"]) == cost
        assert got["counted_flops"] == counted == cost.gemm_flops
        assert got["reckoning"] == SMOKE.dry_reckoning(cfg, shape.kind,
                                                       batch, 32)
        assert got["walk_s"] > 0


def test_meta_peak_bytes_sees_inside_a_composite_op():
    """Under inference mode ``einsum`` reaches the mode whole; on the card
    it copies k to a head-major layout.  The count takes its
    decomposition, so the copy is seen."""
    q = torch.empty(8, 1, 8, 2, 128, dtype=torch.bfloat16, device="meta")
    k = torch.empty(8, 4096, 8, 128, dtype=torch.bfloat16, device="meta")

    @torch.inference_mode()
    def scores():
        return torch.einsum("bskgd,btkd->bkgst", q, k)
    # the copy of k, then the scores beside it
    assert meta_peak_bytes(scores) >= k.numel() * 2


def test_meta_peak_bytes_counts_a_cuda_temporary():
    """``_softmax_backward_data`` holds a temporary as large as its output
    on the card (``CUDA_OP_TEMPORARIES``); the count holds it while the
    op runs."""
    y, g = (torch.empty(64, 4096, device="meta") for _ in range(2))
    op = torch.ops.aten._softmax_backward_data.default
    assert program.CUDA_OP_TEMPORARIES[op] == 1
    assert meta_peak_bytes(
        lambda: op(g, y, -1, torch.float32)) == 2 * 64 * 4096 * 4


@pytest.mark.parametrize("m,n,k", [(8, 151_936, 1024), (8192, 1024, 3072),
                                   (32_768, 3072, 1024)])
def test_kernel_shaped_matmul_allocates_as_the_wrapper(m, n, k):
    from repro_torch.core.gpu_model import select_matmul_block
    a = torch.empty(m, k, dtype=torch.bfloat16, device="meta")
    b = torch.empty(k, n, dtype=torch.bfloat16, device="meta")
    splits = select_matmul_block(m, n, k).splits
    c = program.kernel_shaped().matmul(a, b)
    assert c.shape == (m, n) and c.dtype == torch.bfloat16
    want = m * n * 2 + (splits * m * n * 4 if splits > 1 else 0)
    assert meta_peak_bytes(
        lambda: program.kernel_shaped().matmul(a, b)) == want


@pytest.mark.parametrize("b,h,kv,window", [(1, 4, 2, 0), (2, 6, 2, 5),
                                           (1, 3, 3, 0)])
def test_grouped_plain_and_kv_group_equal_the_plain_attention(
        b, h, kv, window):
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(3)
    s, d = 24, 16
    q = torch.randn(b * h, s, d, generator=gen)
    k, v = (torch.randn(b * kv, s, d, generator=gen) for _ in range(2))
    want = ref.flash_attention_ref(q, k, v, h, kv, True, window)
    got = SMOKE.grouped_plain().flash_attention(q, k, v, h, kv, True,
                                                window)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    g = h // kv
    for j in range(kv):
        cut = SMOKE.kv_group(q, k, v, h, kv, j)
        assert cut[3:] == (g, 1)
        torch.testing.assert_close(
            ref.flash_attention_ref(*cut, True, window).reshape(b, g, s, d),
            want.reshape(b, h, s, d)[:, j * g:(j + 1) * g],
            atol=1e-6, rtol=1e-6)


class _Proc:
    def poll(self):
        return 0

    def wait(self, timeout=None):
        return 0


def test_phase_22_rehearsed_on_the_cpu(monkeypatch):
    """``dryrun_slice`` end to end at reduced size on the CPU: Qwen3-0.6B
    and gemma3-27b reduced, the cells cut to 32 (train), 128 (prefill)
    and 64 (decode) tokens, the CUDA calls and the profiler stubbed, the
    launch counters (which a plain version never touches) not held, the
    fake backend's subprocess stubbed, and ``DRY_PLAIN_ATTN_BYTES``
    lowered so that the prefill's attention alone is held on its first
    KV group."""
    import dataclasses
    import repro_torch.configs as configs
    from repro_torch.launch import shapes as SH
    from test_torch_smoke_helpers import _Event
    full = configs.get_config
    monkeypatch.setattr(configs, "get_config",
                        lambda arch: reduced(full(arch)))
    for name, seq in (("train_4k", 32), ("prefill_32k", 128),
                      ("decode_32k", 64)):
        monkeypatch.setitem(SH.SHAPES, name, dataclasses.replace(
            SH.SHAPES[name], seq=seq))
    qwen = reduced(full("qwen3-0.6b"))
    monkeypatch.setattr(SMOKE, "DRY_PLAIN_ATTN_BYTES",
                        4 * qwen.n_heads * 100 ** 2)
    monkeypatch.setattr(SMOKE, "CARD", "cpu")
    monkeypatch.setattr(SMOKE, "DRY_PEAK_MARGIN_GB", (math.inf, math.inf))
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda *a: (60e9, 80e9))
    monkeypatch.setattr(SMOKE, "counted", lambda what, fn, want, route: (
        fn(), dict(want), {"wgmma": want.get("matmul", 0), "mma": 0}))

    def profile(step, groups):
        step()
        return {"device_ms": 1e9, "parts_ms": {}, "records": {}, "top": []}
    monkeypatch.setattr(SMOKE, "profile_step", profile)
    monkeypatch.setattr(SMOKE, "start_fake_dryrun", lambda *a: _Proc())
    monkeypatch.setattr(SMOKE, "fake_dryrun_record", lambda *a: {
        "status": "ok", "memory": {"argument_bytes": 1, "output_bytes": 1},
        "roofline": {"flops": 1.0, "hbm_bytes": 1.0, "bound": "memory",
                     "step_time_s": 1.0, "model_flops_ratio": 1.0},
        "compile_us": 1.0})
    groups = []
    hold_call = SMOKE.hold_call

    def held_groups(held, name, label, args, kwargs, main=False):
        if label.endswith("its first KV group"):
            groups.append(tuple(args[0].shape) + args[3:5])
        return hold_call(held, name, label, args, kwargs, main)
    monkeypatch.setattr(SMOKE, "hold_call", held_groups)

    report = {}
    got = SMOKE.dryrun_slice(torch.device("cpu"), "cpu", report)
    cfgs = {name: SH.adjust_config(qwen, SH.SHAPES[name])
            for name in ("train_4k", "prefill_32k", "decode_32k")}
    pre = SMOKE.serve_launches(cfgs["prefill_32k"], True)
    step = SMOKE.serve_launches(cfgs["decode_32k"], False)
    train_ = SMOKE.chunked_train_launches(cfgs["train_4k"], 32)
    assert got["launches"] == {
        k: train_.get(k, 0) + pre.get(k, 0)
        + SMOKE.DRY_DECODE_STEPS * step.get(k, 0)
        for k in set(train_) | set(pre) | set(step)}
    assert set(got["held"]) == {"matmul", "fused_add_rmsnorm",
                                "flash_attention"}
    out = report["dryrun"]
    # the prefill's one recorded attention, on its first KV group alone
    g = qwen.n_heads // qwen.n_kv_heads
    assert groups == [(g, 128, qwen.hd, g, 1)]
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        cell = out[name]
        assert cell["outputs_ok"]
        assert cell["row_rel"] <= 1e-2
        assert cell["held"]["matmul"] > 0
        assert cell["held"]["fused_add_rmsnorm"] == 1
        assert cell["gemm_flops"] == cell["flop_counter_flops"] > 0
    assert out["train_4k"]["held"]["flash_attention"] == 1
    assert out["prefill_32k"]["held"]["flash_attention"] == 1
    assert "flash_attention" not in out["decode_32k"]["held"]
    assert out["train_4k"]["loss_rel"] <= 1e-2
    assert set(out["gemma3_attention"]) == {"window_1024", "window_0"}


def test_op_temporaries_script_needs_a_card(monkeypatch, capsys):
    """``scripts/op_temporaries.py`` reads the card's allocator: without
    a card it exits non-zero and prints no record."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "op_temporaries.py"
    spec = importlib.util.spec_from_file_location("op_temporaries", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert module.main(["--cell", "decode_32k"]) == 1
    assert capsys.readouterr().out == ""

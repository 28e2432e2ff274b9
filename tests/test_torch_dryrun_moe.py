"""The dry run of the MoE configs on the partitioned route
(``models/moe.py``: the experts on ``data``, an explicit all-to-all over
it), on the CPU:

* granite-moe-1b's ``train_4k``, ``prefill_32k`` and ``decode_32k`` at
  full size on the 16 x 16 mesh through ``python -m
  repro_torch.launch.dryrun`` (on the ``fake`` backend, in a
  subprocess) record the temp, alias and collective terms of rank 0's
  program, the dispatch under ``"all-to-all"`` in closed form;
* one of granite's MoE layers alone on rank 0 of that mesh (its forward
  and backward under ``launch.program.StepReader``): with whole blocks a
  rank (``train_4k``'s 64 of 1,024 tokens) the only collectives of the
  dispatched rows are four all-to-alls over ``data`` (dispatch and
  return, forward and backward), each of the rows' bytes, of which
  15/16 cross; with one block over the 16 data ranks (``decode_32k``)
  the rows are reduce-scattered onto their experts and nothing gathers
  them or the activations;
* a reduced granite cell's collectives by kind against the JAX
  package's HLO-derived ``roofline.collective_bytes`` (``tests/
  test_torch_dryrun.py::hlo_collectives``): the port's MoE layers move
  the closed form's bytes, and no more than the reference's MoE layers
  do; the differences, which are the compilers' and the dispatch's, are
  named in the test.

Every comparison is exact.
"""
import json
import math
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun import hlo_collectives  # noqa: E402
from test_torch_ranks import ROOT, env  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import shapes  # noqa: E402
from repro_torch.models.moe import _capacity  # noqa: E402

GRANITE = "granite-moe-1b-a400m"
SHAPES = ("train_4k", "prefill_32k", "decode_32k")

CELLS = r"""
import json, sys, tempfile
from repro_torch.launch import dryrun
shape = sys.argv[1]
with tempfile.TemporaryDirectory() as tmp:
    dryrun.main(["--arch", "granite-moe-1b-a400m", "--shape", shape,
                 "--out", tmp])
    rec = json.loads(open(
        f"{tmp}/granite-moe-1b-a400m.{shape}.16x16.json").read())
print("CELL " + json.dumps(rec))
"""

LAYER = r"""
import json
import torch
from torch.distributed.tensor import Shard
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, program
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.train import make_state_shardings
from repro_torch.models import moe
from repro_torch.models.common import (P, PROD_RULES, placed_zeros,
                                       placements, with_axis_sizes)
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamW, constant_schedule

out = {}
with dryrun.fake_world(False):
    mesh = make_production_mesh(device_type="cpu")
    rules = with_axis_sizes(PROD_RULES, mesh)
    cfg = get_config("granite-moe-1b-a400m")
    model = Model(cfg)
    defs = model.abstract()["blk0"]["mlp"]
    sh = make_state_shardings(model, AdamW(schedule=constant_schedule(
        1e-4)), rules, mesh)["params"]["blk0"]["mlp"]
    part = ops.partitioned(program.kernel_shaped(), mesh, rules)
    for name, (b, s) in {"blocks": (256, 4096), "spanning": (128, 1)}.items():
        p = {k: placed_zeros(defs[k].shape[1:], cfg.dtype, mesh,
                             [Shard(q.dim - 1) if isinstance(q, Shard)
                              else q for q in pl], "meta").requires_grad_()
             for k, (_, pl) in sh.items()}
        x = placed_zeros((b, s, cfg.d_model), cfg.dtype, mesh,
                         placements(P("data", None, None), mesh),
                         "meta").requires_grad_()
        reader = program.StepReader()
        with reader:
            y, aux = moe.apply_moe(cfg, p, x, rules, part)
            torch.autograd.grad(y.to_local().float().sum()
                                + aux.to_local(), [x] + list(p.values()))
        out[name] = {"calls": reader.calls, "sizes": reader.sizes,
                     "y": [str(q) for q in y.placements],
                     "local": list(y.to_local().shape)}
print("LAYER " + json.dumps(out))
"""


def _run(script, tag, *args):
    res = subprocess.run([sys.executable, "-c", script, *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=900,
                         env=env())
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith(tag)]
    assert lines, res.stdout[-3000:] + res.stderr[-3000:]
    return json.loads(lines[-1][len(tag):])


@pytest.fixture(scope="module")
def cells():
    """granite's three full-size cells, each dry run in a process of its
    own, all at once."""
    procs = {s: subprocess.Popen([sys.executable, "-c", CELLS, s], cwd=ROOT,
                                 text=True, env=env(),
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE) for s in SHAPES}
    out = {}
    try:
        for s, proc in procs.items():
            text, err = proc.communicate(timeout=900)
            lines = [ln for ln in text.splitlines() if ln.startswith("CELL ")]
            assert lines, text[-3000:] + err[-3000:]
            out[s] = json.loads(lines[-1][len("CELL "):])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def _rows(cfg, tokens):
    """Bytes of the (nblk, E, C, d) rows dispatched from ``tokens``."""
    return (tokens // cfg.moe_block * cfg.n_experts * _capacity(cfg)
            * cfg.d_model * 2)


@pytest.mark.parametrize("shape", SHAPES)
def test_granite_cells_read_the_partitioned_step(cells, shape):
    """The MoE cells lose their ``"why"``: temp, alias and collectives
    are rank 0's.  Whole blocks a rank (train, prefill: 16 and 2 rows of
    the batch, 64 blocks of 1,024) exchange the dispatched rows by
    all-to-all, twice a layer and pass (forward; under remat ``full``
    the recompute and the backward too); decode's one block over the 16
    data ranks reduce-scatters its partial rows onto the experts."""
    rec = cells[shape]
    mem, roof = rec["memory"], rec["roofline"]
    assert "why" not in mem and "why" not in roof
    assert isinstance(mem["temp_bytes"], int) and mem["temp_bytes"] > 0
    cfg = get_config(GRANITE)
    spec = shapes.SHAPES[shape]
    kinds = roof["collective_by_kind"]
    assert sum(kinds.values()) == roof["collective_bytes"] == \
        256 * roof["collective_bytes_per_device"]
    assert roof["t_collective_s"] == pytest.approx(
        roof["collective_bytes_per_device"] / 450e9, rel=1e-12)
    tokens = spec.global_batch * spec.seq // 16
    passes = {"train": 6, "prefill": 2, "decode": 0}[spec.kind]
    assert kinds.get("all-to-all", 0) == 256 * passes * cfg.n_layers \
        * _rows(cfg, tokens)
    # the decode cache, 24 layers x (k, v) of 8 rows x 32,768 x 8 KV
    # heads x 64 in bfloat16 (8 KV heads do not divide 16) plus the int32
    # positions
    want_alias = 24 * 2 * 8 * 32768 * 8 * 64 * 2 + 24 * 4 \
        if spec.kind == "decode" else 0
    assert mem["alias_bytes"] == want_alias


@pytest.fixture(scope="module")
def layer():
    return _run(LAYER, "LAYER ")


def _bytes(call, dtype_size):
    return math.prod(call[1]) * dtype_size


def test_a_moe_layers_all_to_all_has_the_closed_form(layer):
    """``train_4k``'s layer on rank 0: the dispatched rows (64 blocks x
    32 experts x 320 slots x 1,024, bfloat16: 1.34 GB) cross by four
    all-to-alls over the 16 ranks of ``data``, each of the rows' bytes,
    so 15/16 of them leave the rank each time; nothing of that size is
    gathered, and the output stays ``Partial`` over ``model``."""
    cfg = get_config(GRANITE)
    rows = _rows(cfg, 16 * 4096)
    assert rows == 64 * 32 * 320 * 1024 * 2
    got = layer["blocks"]
    a2a = [(c, n) for c, n in zip(got["calls"], got["sizes"])
           if c[0] == "all-to-all"]
    assert len(a2a) == 4
    assert all(_bytes(c, 2) == rows and n == 16 for c, n in a2a)
    moved = sum(_bytes(c, 2) * (n - 1) / n for c, n in a2a)
    assert moved == 4 * rows * 15 / 16
    assert all(_bytes(c, 4) < rows / 16 for c in got["calls"]
               if c[0] != "all-to-all")
    assert got["y"] == ["S(0)", "P(sum)"]
    assert got["local"] == [16, 4096, 1024]


def test_a_spanning_block_is_reduce_scattered_onto_its_experts(layer):
    """``decode_32k``'s layer on rank 0 (8 of the block's 128 tokens): the
    partial rows (32 x 320 x 1,024) are reduce-scattered onto the 2
    experts of each of the 16 data ranks; the forward's gathers are the
    router's FSDP weight and the block's int64 choices and ranks and
    float32 gates (128 x 8 each), never the activations; no all-to-all.
    A backward (a training step whose blocks span ranks; no cell of the
    dry run has one) gathers what the forward scattered: the rows'
    gradient, and the block's output gradient (128 x 1,024)."""
    cfg = get_config(GRANITE)
    got = layer["spanning"]
    kinds = [c[0] for c in got["calls"]]
    assert "all-to-all" not in kinds
    slots = cfg.n_experts * _capacity(cfg) * cfg.d_model
    scattered = [c for c in got["calls"] if c[0] == "reduce-scatter"
                 and math.prod(c[1]) == slots // 16]
    assert len(scattered) == 1
    gathered = [c for c in got["calls"] if c[0] == "all-gather"]
    router = cfg.d_model * cfg.n_experts
    assert sorted(math.prod(c[1]) for c in gathered) == sorted(
        [router] + [128 * cfg.top_k] * 4 + [128 * cfg.d_model, slots])
    assert got["local"] == [8, 1, 1024]


HLO_CELLS = {"prefill_32k": (4, 64), "decode_32k": (4, 64)}
HLO_KW = {"vocab_size": 512}


@pytest.fixture(scope="module")
def against_hlo():
    return hlo_collectives(HLO_CELLS, HLO_KW, GRANITE)


@pytest.mark.parametrize("cell", sorted(HLO_CELLS))
def test_granite_collectives_against_the_reference_hlo(against_hlo, cell):
    """Reduced granite (8 experts, top-2, blocks of 64, 2 layers; float32)
    on a (2, 2) mesh, a prefill of 4 x 64 and a decode step.

    The port's MoE layers move what the closed form says: whole blocks
    (prefill: 2 a data rank) the rows by two all-to-alls a layer, a
    block over both data ranks (decode) the partial rows by a
    reduce-scatter onto the experts and the output rows back; beside
    them the router's FSDP gather and the aux loss's all-reduce (and
    decode's gathered choices, ranks and gates).  The reference maps one
    block at a time with every block's tokens split over ``data``, and
    XLA lays each block's tokens out by an all-to-all (the map's slice of
    the block) and sums its partial dispatch and outputs by all-reduce:
    it has no all-to-all of the rows.  The port's MoE layers move no more
    than the reference's; the cell as a whole moves no more either once
    the lookup's table gather, which the reference makes with the token
    ids (``tests/test_torch_dryrun.py``), is set aside."""
    ref, port = (side[cell] for side in against_hlo)
    ref_moe, port_moe = (side[cell + "/moe"] for side in against_hlo)
    cfg = reduced(get_config(GRANITE)).replace(**HLO_KW)
    batch, seq = HLO_CELLS[cell]
    layers, e, d = cfg.n_layers, cfg.n_experts, cfg.d_model
    k, cap = cfg.top_k, _capacity(cfg)
    router = layers * d * e * 4
    if cell == "prefill_32k":
        nblk = batch * seq // 2 // cfg.moe_block
        rows = nblk * e * cap * d * 4
        want = {"all-to-all": layers * 2 * rows, "all-gather": router,
                "all-reduce": layers * 4}
        tokens = batch * seq
    else:
        n, n_loc = batch, batch // 2
        want = {"reduce-scatter": layers * (e // 2 * cap * d * 4
                                            + n_loc * d * 4),
                "all-gather": router + layers * (2 * n * k * 8
                                                 + n * k * 8 + n * k * 4),
                "all-reduce": layers * 4}
        tokens = batch
    assert port_moe == want
    assert ref_moe.get("all-to-all", 0) <= layers * tokens * d * 4
    assert ref_moe["all-reduce"] > 0
    assert sum(port_moe.values()) <= sum(ref_moe.values())
    table = cfg.vocab_size // 2 * d * 4
    assert sum(port.values()) - table <= sum(ref.values()) - tokens * 4

"""The dry run of mamba2-130m and recurrentgemma-9b on the partitioned
route (``models/ssm.py`` and ``models/rglru.py`` on ``DTensor``s), on the
CPU:

* full-size cells on the 16 x 16 mesh through ``python -m
  repro_torch.launch.dryrun`` (the ``fake`` backend, a process a cell,
  all at once) record the temp, alias and collective terms of rank 0's
  program: mamba2's ``decode_32k`` and ``long_500k`` (batch 1, no KV
  cache, the state whole), recurrentgemma's ``decode_32k``,
  ``prefill_32k`` and ``train_4k`` (mamba2's ``train_4k`` and
  ``prefill_32k`` take a minute or more to trace; ``chip_smoke.py``'s
  phase 24 holds them on the card); the decode caches written in place
  in closed form;
* one RG-LRU layer alone on rank 0 of that mesh at ``train_4k``'s
  shape: r's and i's row-parallel float32 products are reduce-scattered
  onto ``rnn`` (``model``), and the forward gathers no activation, only
  the FSDP weights; the backward gathers r's and i's gradients, which
  the row-parallel products' input gradients read whole, and no other
  activation;
* reduced cells of both configs against the JAX package's HLO-derived
  ``roofline.collective_bytes`` (``tests/test_torch_dryrun.py::
  hlo_collectives``): the mixers' forward collectives in closed form,
  each cell moving no more than the reference's, and recurrentgemma's
  decode step equal to it kind by kind once the differences named in
  ``test_recurrentgemma_decode_equals_the_reference_hlo`` are set aside.

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
from repro_torch.models.ssm import ssm_dims  # noqa: E402

MAMBA2, RG = "mamba2-130m", "recurrentgemma-9b"
CELLS = [(MAMBA2, "decode_32k"), (MAMBA2, "long_500k"),
         (RG, "decode_32k"), (RG, "prefill_32k"), (RG, "train_4k")]

CELL = r"""
import json, sys, tempfile
from repro_torch.launch import dryrun
arch, shape = sys.argv[1:]
with tempfile.TemporaryDirectory() as tmp:
    dryrun.main(["--arch", arch, "--shape", shape, "--out", tmp])
    rec = json.loads(open(f"{tmp}/{arch}.{shape}.16x16.json").read())
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
from repro_torch.models import rglru
from repro_torch.models.common import (P, PROD_RULES, placed_zeros,
                                       placements, with_axis_sizes)
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamW, constant_schedule

with dryrun.fake_world(False):
    mesh = make_production_mesh(device_type="cpu")
    rules = with_axis_sizes(PROD_RULES, mesh)
    cfg = get_config("recurrentgemma-9b")
    model = Model(cfg)
    defs = model.abstract()["blk0"]["rglru"]
    sh = make_state_shardings(model, AdamW(schedule=constant_schedule(
        1e-4)), rules, mesh)["params"]["blk0"]["rglru"]
    part = ops.partitioned(program.kernel_shaped(), mesh, rules)
    p = {k: placed_zeros(defs[k].shape[1:], cfg.dtype, mesh,
                         [Shard(q.dim - 1) if isinstance(q, Shard) else q
                          for q in pl], "meta").requires_grad_()
         for k, (_, pl) in sh.items()}
    x = placed_zeros((256, 4096, cfg.d_model), cfg.dtype, mesh,
                     placements(P("data", None, None), mesh),
                     "meta").requires_grad_()
    forward, backward = program.StepReader(), program.StepReader()
    with forward:
        y, _ = rglru.apply_rglru(cfg, p, x, rules, None, part)
    with backward:
        torch.autograd.grad(y.to_local().float().sum(),
                            [x] + list(p.values()))
    out = {"forward": {"calls": forward.calls, "sizes": forward.sizes},
           "backward": {"calls": backward.calls, "sizes": backward.sizes},
           "y": [str(q) for q in y.placements],
           "local": list(y.to_local().shape)}
print("LAYER " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def cells():
    """The full-size cells, each dry run in a process of its own, all at
    once."""
    procs = {c: subprocess.Popen([sys.executable, "-c", CELL, *c], cwd=ROOT,
                                 text=True, env=env(),
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE) for c in CELLS}
    out = {}
    try:
        for c, proc in procs.items():
            text, err = proc.communicate(timeout=600)
            lines = [ln for ln in text.splitlines() if ln.startswith("CELL ")]
            assert lines, text[-3000:] + err[-3000:]
            out[c] = json.loads(lines[-1][len("CELL "):])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def _cache_bytes(arch, batch):
    """Bytes of rank 0's decode cache written in place: each mamba2 layer's
    SSD state (its 24 heads whole: they do not divide 16) and conv tail;
    each RG-LRU layer's state (rnn split 16 ways) and conv tail (whole on
    ``model``); each attention layer's KV rows (its one KV head whole) and
    int32 position."""
    cfg = get_config(arch)
    kinds = cfg.layer_kinds()
    if arch == MAMBA2:
        di, h, n = ssm_dims(cfg)
        return len(kinds) * batch * (h * cfg.ssm_head_dim * n
                                     + (cfg.conv_width - 1) * (di + 2 * n)) * 4
    rec, att = kinds.count("rglru"), kinds.count("attn")
    r = cfg.rnn_width
    return (rec * batch * (r // 16 + (cfg.conv_width - 1) * r) * 4
            + att * (2 * batch * 32768 * cfg.hd * 2 + 4))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_recurrent_cells_read_the_partitioned_step(cells, arch, shape):
    """The cells lose their ``"why"``: temp, alias and collectives are
    rank 0's; a decode cell writes its cache in place (mamba2's
    ``long_500k``: its one row whole on every rank, no KV cache)."""
    rec = cells[arch, shape]
    mem, roof = rec["memory"], rec["roofline"]
    assert "why" not in mem and "why" not in roof
    assert isinstance(mem["temp_bytes"], int) and mem["temp_bytes"] > 0
    kinds = roof["collective_by_kind"]
    assert set(kinds) <= {"all-gather", "reduce-scatter", "all-reduce"}
    assert sum(kinds.values()) == roof["collective_bytes"] == \
        256 * roof["collective_bytes_per_device"] > 0
    assert roof["t_collective_s"] == pytest.approx(
        roof["collective_bytes_per_device"] / 450e9, rel=1e-12)
    batch = {"decode_32k": 8, "long_500k": 1}.get(shape)
    want_alias = 0 if batch is None else _cache_bytes(arch, batch)
    assert mem["alias_bytes"] == want_alias


def test_the_decode_steps_reduce_scatter_r_and_i(cells):
    """recurrentgemma's decode step: each of its 26 RG-LRU layers
    reduce-scatters r's and i's float32 products (8 rows, 4,096 channels,
    256 a rank) and nothing else is reduce-scattered; mamba2's decode
    steps reduce-scatter nothing (its outputs, one token a row, are
    all-reduced onto the stream)."""
    roof = cells[RG, "decode_32k"]["roofline"]
    per_device = roof["collective_by_kind"]["reduce-scatter"] // 256
    assert per_device == 26 * 2 * 8 * 256 * 4
    for shape in ("decode_32k", "long_500k"):
        assert "reduce-scatter" not in cells[MAMBA2, shape]["roofline"][
            "collective_by_kind"]


@pytest.fixture(scope="module")
def layer():
    res = subprocess.run([sys.executable, "-c", LAYER], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=env())
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("LAYER ")]
    assert lines, res.stdout[-3000:] + res.stderr[-3000:]
    return json.loads(lines[-1][len("LAYER "):])


def test_an_rglru_layer_reduce_scatters_r_and_i(layer):
    """``train_4k``'s RG-LRU layer on rank 0 (16 rows of 4,096 tokens):
    the forward's only collectives are ``w_x``'s, ``w_gate``'s and
    ``w_out``'s FSDP gathers over ``data`` (4,096 x 256 bfloat16 each)
    and r's and i's reduce-scatters onto ``rnn`` over ``model`` (16 x
    4,096 x 256 float32 each); x is never gathered; the output stays
    ``Partial`` over ``model``."""
    cfg = get_config(RG)
    d, r = cfg.d_model, cfg.rnn_width
    fwd = layer["forward"]
    calls = sorted((c[0], math.prod(c[1]), n)
                   for c, n in zip(fwd["calls"], fwd["sizes"]))
    assert calls == sorted([("all-gather", d * r // 16, 16)] * 3
                           + [("reduce-scatter", 16 * 4096 * r // 16, 16)]
                           * 2)
    assert layer["y"] == ["S(0)", "P(sum)"]
    assert layer["local"] == [16, 4096, d]


def test_an_rglru_layers_backward_gathers_r_and_i_gradients(layer):
    """The backward gathers r's and i's gradients whole over ``model``
    (the row-parallel products' input gradients read them whole) and
    nothing else (the forward's gathered weights are kept: no remat
    here); every other collective is a weight gradient's (at most d x r /
    16 elements), never an activation's."""
    cfg = get_config(RG)
    d, r = cfg.d_model, cfg.rnn_width
    bwd = layer["backward"]
    calls = [(c[0], math.prod(c[1]), n)
             for c, n in zip(bwd["calls"], bwd["sizes"])]
    gathered = [(n, g) for kind, n, g in calls if kind == "all-gather"]
    assert gathered == [(16 * 4096 * r, 16)] * 2
    assert all(n <= d * r // 16 for kind, n, _ in calls
               if kind != "all-gather")


# reduced cells against the reference's HLO: float32, vocabulary 512, a
# (2, 2) ("data", "model") mesh, a global batch of 4 and 64 tokens
HLO_CELLS = {"train_4k": (4, 64), "prefill_32k": (4, 64),
             "decode_32k": (4, 64)}
HLO_KW = {"vocab_size": 512}


@pytest.fixture(scope="module")
def against_hlo():
    """``{arch: (reference, port)}`` for both configs, both at once."""
    import concurrent.futures as cf
    with cf.ThreadPoolExecutor(2) as pool:
        futs = {a: pool.submit(hlo_collectives, HLO_CELLS, HLO_KW, a)
                for a in (MAMBA2, RG)}
        return {a: f.result() for a, f in futs.items()}


def _lookup(cfg, tokens):
    """The embedding lookup's difference (``tests/test_torch_dryrun.py``):
    the port gathers its table's half over ``data``, the reference the
    token ids."""
    return cfg.vocab_size // 2 * cfg.d_model * 4, tokens * 4


@pytest.mark.parametrize("arch", [MAMBA2, RG])
@pytest.mark.parametrize("cell", ["prefill_32k", "decode_32k"])
def test_mixer_collectives_have_the_closed_form(against_hlo, arch, cell):
    """The mixers' forward collectives (those issued inside ``apply_ssm``
    and ``apply_rglru``), rank 0 of the (2, 2) mesh, 2 rows a rank:

    * SSD, a layer: ``w_in``'s and ``w_out``'s FSDP gathers; the packed
      projection made whole on ``model`` (2 x S x 296); ``conv_w``
      gathered whole (4 x 160); the gated norm's sum of squares summed
      over ``model`` (2 x S);
    * RG-LRU, a layer: ``w_x``'s, ``w_gate``'s and ``w_out``'s FSDP
      gathers; r's and i's reduce-scatters (2 x S x 32 each); the new
      conv state gathered whole over ``model`` (2 x 3 x 64, the cache
      given by the prefill and the decode step)."""
    _, port = against_hlo[arch]
    cfg = reduced(get_config(arch)).replace(**HLO_KW)
    s = 1 if cell == "decode_32k" else HLO_CELLS[cell][1]
    d = cfg.d_model
    if arch == MAMBA2:
        di, h, n = ssm_dims(cfg)
        cols = 2 * di + 2 * n + h
        gathered = (d * cols // 2 + 2 * s * cols
                    + cfg.conv_width * (di + 2 * n) + di // 2 * d) * 4
        want = {"all-gather": cfg.n_layers * gathered,
                "all-reduce": cfg.n_layers * 2 * s * 4}
        assert port[cell + "/ssm"] == want and port[cell + "/rglru"] == {}
    else:
        r = cfg.rnn_width
        layers = cfg.layer_kinds().count("rglru")
        want = {"all-gather": layers * (3 * d * r // 2
                                        + 2 * (cfg.conv_width - 1) * r) * 4,
                "reduce-scatter": layers * 2 * 2 * s * r // 2 * 4}
        assert port[cell + "/rglru"] == want and port[cell + "/ssm"] == {}


@pytest.mark.parametrize("arch", [MAMBA2, RG])
@pytest.mark.parametrize("cell", sorted(HLO_CELLS))
def test_recurrent_cells_move_no_more_than_the_reference(against_hlo, arch,
                                                          cell):
    """Each reduced cell's collective bytes against the reference's, the
    embedding lookup's difference set aside: no more, where the
    reference moves its packed SSD projection's parts by
    collective-permute and all-to-all and gathers the new conv state
    (computed on split channels), all-reduces r and i whole, and lays
    the stream out between the sequence and the channels by all-to-all.
    recurrentgemma's decode step is the exception, held exactly by
    ``test_recurrentgemma_decode_equals_the_reference_hlo``."""
    ref, port = (side[cell] for side in against_hlo[arch])
    cfg = reduced(get_config(arch)).replace(**HLO_KW)
    batch, seq = HLO_CELLS[cell]
    table, ids = _lookup(cfg, batch * (1 if cell == "decode_32k" else seq))
    assert set(port) <= {"all-gather", "all-reduce", "reduce-scatter"}
    if arch == RG and cell == "decode_32k":
        return
    assert sum(port.values()) - table <= sum(ref.values()) - ids


def test_recurrentgemma_decode_equals_the_reference_hlo(against_hlo):
    """recurrentgemma's reduced decode step (5 RG-LRU and 2 attention
    layers) moves the reference's bytes of each kind once three
    differences are set aside:

    * the embedding lookup (``_lookup``; the reference also lays the
      looked-up rows out by an all-to-all and a collective-permute);
    * the CPU's XLA forms no reduce-scatter: it all-reduces r and i whole
      (2 rows x 64 channels each, a layer) and slices them, where the
      port reduce-scatters them onto ``rnn``: its reduce-scatter over a
      group of 2 is that all-reduce at half its output's bytes;
    * the attention's one KV head (whole on ``model``: 1 does not divide
      2): the port gathers ``wk`` and ``wv`` over ``data`` (64 x 16
      each); XLA exchanges their halves by collective-permute (32 x 16
      each) and all-reduces the partial k and v (2 rows x 16 each)."""
    ref, port = (side["decode_32k"] for side in against_hlo[RG])
    cfg = reduced(get_config(RG)).replace(**HLO_KW)
    att = cfg.layer_kinds().count("attn")
    d, hd = cfg.d_model, cfg.hd
    table, ids = _lookup(cfg, 4)
    rows = 2 * cfg.d_model * 4              # the looked-up rows, laid out
    kv_gather = att * 2 * d * hd * 4
    kv_permute = att * 2 * d // 2 * hd * 4
    kv_reduce = att * 2 * 2 * hd * 4
    assert port["all-gather"] - table - kv_gather == \
        ref["all-gather"] - ids
    # beside the halves, the lookup's 2 rows of token ids (int32)
    assert ref["collective-permute"] == kv_permute + 2 * 4
    assert ref["all-to-all"] == rows
    assert port["all-reduce"] + 2 * port["reduce-scatter"] == \
        ref["all-reduce"] - kv_reduce

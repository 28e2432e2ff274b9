"""The dry run of whisper-tiny and pixtral-12b on the partitioned route
(the encoder, cross-attention, learned positions and the patch prefix
on ``DTensor``s), on the CPU:

* all six full-size cells -- ``train_4k``, ``prefill_32k`` and
  ``decode_32k`` of both -- on the 16 x 16 mesh through ``python -m
  repro_torch.launch.dryrun`` (the ``fake`` backend, a process a cell,
  all at once; the slowest, whisper's ``train_4k``, traces in about
  30 s) record the temp, alias and collective terms of rank 0's program,
  its train and prefill steps fed the cell's frames or patches; a decode
  cell writes its self-attention KV cache in place, in closed form, and
  only reads whisper's cross-attention K/V;
* reduced cells of both configs against the JAX package's HLO-derived
  ``roofline.collective_bytes`` (``tests/test_torch_dryrun.py::
  hlo_collectives``): each moves no more than the reference's, and each
  decode step moves the reference's bytes of each kind once the
  differences named in ``test_decode_equals_the_reference_hlo`` are set
  aside.

Every comparison is exact.
"""
import json
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun import hlo_collectives  # noqa: E402
from test_torch_ranks import ROOT, env  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402

WHISPER, PIXTRAL = "whisper-tiny", "pixtral-12b"
CELLS = [(a, s) for a in (WHISPER, PIXTRAL)
         for s in ("train_4k", "prefill_32k", "decode_32k")]

CELL = r"""
import json, sys, tempfile
from repro_torch.launch import dryrun
arch, shape = sys.argv[1:]
with tempfile.TemporaryDirectory() as tmp:
    dryrun.main(["--arch", arch, "--shape", shape, "--out", tmp])
    rec = json.loads(open(f"{tmp}/{arch}.{shape}.16x16.json").read())
print("CELL " + json.dumps(rec))
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


def _self_attention_cache(arch, batch, rows):
    """Bytes of rank 0's decode cache written in place: each decoder
    layer's K and V rows (the KV heads whole on ``model``: whisper's 6
    and pixtral's 8 do not divide 16) and int32 position, and whisper's
    int32 learned-position offset.  whisper's ``_cross`` K/V, 1,500
    encoder rows a layer, are only read."""
    cfg = get_config(arch)
    kv = cfg.n_layers * 2 * batch * rows * cfg.n_kv_heads * cfg.hd * 2
    return kv + cfg.n_layers * 4 + (4 if cfg.learned_pos else 0)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_frontend_cells_read_the_partitioned_step(cells, arch, shape):
    """The cells lose their ``"why"``: temp, alias and collectives are
    rank 0's; a decode cell writes its self-attention cache in place."""
    rec = cells[arch, shape]
    assert rec["status"] == "ok"
    mem, roof = rec["memory"], rec["roofline"]
    assert "why" not in mem and "why" not in roof
    assert isinstance(mem["temp_bytes"], int) and mem["temp_bytes"] > 0
    kinds = roof["collective_by_kind"]
    assert set(kinds) <= {"all-gather", "reduce-scatter", "all-reduce"}
    assert sum(kinds.values()) == roof["collective_bytes"] == \
        256 * roof["collective_bytes_per_device"] > 0
    assert roof["t_collective_s"] == pytest.approx(
        roof["collective_bytes_per_device"] / 450e9, rel=1e-12)
    want_alias = (_self_attention_cache(arch, 8, 32768)
                  if shape == "decode_32k" else 0)
    assert mem["alias_bytes"] == want_alias


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
                for a in (WHISPER, PIXTRAL)}
        return {a: f.result() for a, f in futs.items()}


def _lookup(cfg, tokens):
    """The embedding lookup's difference (``tests/test_torch_dryrun.py``):
    the port gathers its table's half over ``data``, the reference the
    token ids."""
    return cfg.vocab_size // 2 * cfg.d_model * 4, tokens * 4


@pytest.mark.parametrize("arch,cell", [
    (a, c) for a in (WHISPER, PIXTRAL) for c in sorted(HLO_CELLS)
    if (a, c) != (PIXTRAL, "decode_32k")])
def test_frontend_cells_move_no_more_than_the_reference(against_hlo, arch,
                                                        cell):
    """Each reduced cell's collective bytes against the reference's, the
    embedding lookup's difference set aside: no more.  The reference
    also lays the stream out between the sequence and the channels by
    all-to-all and collective-permute; the port reduce-scatters a
    row-parallel product's residual onto the sequence (``seq_resid``)
    and gathers each norm once for its readers.  pixtral's decode step,
    which gathers its one KV head's weights whole, is held exactly by
    ``test_decode_equals_the_reference_hlo``."""
    ref, port = (side[cell] for side in against_hlo[arch])
    cfg = reduced(get_config(arch)).replace(**HLO_KW)
    batch, seq = HLO_CELLS[cell]
    table, ids = _lookup(cfg, batch * (1 if cell == "decode_32k" else seq))
    assert set(port) <= {"all-gather", "all-reduce", "reduce-scatter"}
    assert sum(port.values()) - table <= sum(ref.values()) - ids


@pytest.mark.parametrize("arch", [WHISPER, PIXTRAL])
def test_decode_equals_the_reference_hlo(against_hlo, arch):
    """A reduced decode step (2 decoder layers) moves the reference's
    bytes of each kind once these are set aside:

    * the embedding lookup (``_lookup``; the reference also lays the
      looked-up rows out by an all-to-all and sends 2 rows of token ids
      by collective-permute);
    * pixtral's one KV head (whole on ``model``: 1 does not divide 2):
      the port gathers ``wk`` and ``wv`` over ``data`` (64 x 16 each);
      XLA exchanges their halves by collective-permute (32 x 16 each)
      and all-reduces the partial k and v (2 rows x 16 each).

    whisper's step moves the same all-gathers (its positions' one row
    among them) and all-reduces; the cross-attention reads the cache's
    K/V where they lie."""
    ref, port = (side["decode_32k"] for side in against_hlo[arch])
    cfg = reduced(get_config(arch)).replace(**HLO_KW)
    d, hd = cfg.d_model, cfg.hd
    table, ids = _lookup(cfg, 4)
    assert ref["all-to-all"] == 2 * d * 4    # the looked-up rows, laid out
    kv_gather = kv_permute = kv_reduce = 0
    if arch == PIXTRAL:
        kv_gather = cfg.n_layers * 2 * d * hd * 4
        kv_permute = cfg.n_layers * 2 * d // 2 * hd * 4
        kv_reduce = cfg.n_layers * 2 * 2 * hd * 4
    assert ref["collective-permute"] == kv_permute + 2 * 4
    assert port["all-gather"] - table - kv_gather == \
        ref["all-gather"] - ids
    assert port["all-reduce"] == ref["all-reduce"] - kv_reduce
    assert "reduce-scatter" not in port

"""The dry run of the cells whose KV cache is split on the sequence or
held in int8 (``models/attention.py::_attend_split`` on ``DTensor``s),
on the CPU:

* full-size cells through ``python -m repro_torch.launch.dryrun`` (the
  ``fake`` backend, a process a cell, all at once) record the temp,
  alias and collective terms of rank 0's program: gemma3-27b's
  ``long_500k`` (its cache on ``cache_seq`` = ``data``: batch 1 does not
  split over 16 data ranks), Qwen3-0.6B's ``decode_32k`` under
  ``--optimized`` (an int8 cache with ``cache_seq`` on ``model``) and
  recurrentgemma-9b's ``long_500k`` under ``--multi-pod`` (its cache on
  ``("pod", "data")``, 32 shards); each decode cache written in place
  in closed form (recurrentgemma's ``long_500k`` on one pod is in
  ``tests/test_torch_dryrun.py``);
* reduced Qwen3 cells with the cache on ``data`` (``long_500k``'s rules,
  batch 1) and on ``model`` in int8 (``--optimized``'s) against the JAX
  package's HLO-derived ``roofline.collective_bytes``
  (``tests/test_torch_dryrun.py::hlo_collectives``), each difference
  named.

Every comparison is exact.
"""
import json
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun import HLO_KW, hlo_collectives  # noqa: E402
from test_torch_ranks import ROOT, env  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402

GEMMA, QWEN, RG = "gemma3-27b", "qwen3-0.6b", "recurrentgemma-9b"
# (arch, shape, the dry run's flags)
CELLS = [(GEMMA, "long_500k", ()), (QWEN, "decode_32k", ("--optimized",)),
         (RG, "long_500k", ("--multi-pod",))]

CELL = r"""
import json, sys, tempfile
from repro_torch.launch import dryrun
arch, shape, *flags = sys.argv[1:]
mesh = "2x16x16" if "--multi-pod" in flags else "16x16"
tag = ".opt" if "--optimized" in flags else ""
with tempfile.TemporaryDirectory() as tmp:
    dryrun.main(["--arch", arch, "--shape", shape, "--out", tmp, *flags])
    rec = json.loads(open(f"{tmp}/{arch}.{shape}.{mesh}{tag}.json").read())
print("CELL " + json.dumps(rec))
"""


@pytest.fixture(scope="module")
def cells():
    """The full-size cells, each dry run in a process of its own, all at
    once."""
    procs = {c: subprocess.Popen([sys.executable, "-c", CELL, c[0], c[1],
                                  *c[2]], cwd=ROOT, text=True, env=env(),
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE) for c in CELLS}
    out = {}
    try:
        for c, proc in procs.items():
            text, err = proc.communicate(timeout=600)
            lines = [ln for ln in text.splitlines() if ln.startswith("CELL ")]
            assert lines, text[-3000:] + err[-3000:]
            out[c[:2]] = json.loads(lines[-1][len("CELL "):])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def _local(n: int, ways: int) -> int:
    """A dimension of ``n`` split ``ways`` ways, or whole where the split
    does not divide it (``spec``'s fallback)."""
    return n // ways if n % ways == 0 else n


def cache_bytes(arch: str, batch: int, rows: int, kv_ways: int,
                int8: bool = False) -> int:
    """Bytes of rank 0's decode cache written in place: each attention
    layer's K and V (``batch`` x ``rows`` local rows x its KV heads split
    ``kv_ways`` ways; in int8 with a float32 scale a row and head) and
    its int32 position; each RG-LRU layer's state (``rnn`` split 16
    ways) and conv tail (whole on ``model``)."""
    cfg = get_config(arch)
    kinds = cfg.layer_kinds()
    kv = _local(cfg.n_kv_heads, kv_ways)
    row = kv * (cfg.hd + 4) if int8 else kv * cfg.hd * 2
    out = kinds.count("attn") * (2 * batch * rows * row + 4)
    r = cfg.rnn_width or cfg.d_model
    return out + kinds.count("rglru") * batch * (
        r // 16 + (cfg.conv_width - 1) * r) * 4


# (local batch, local rows, the ways the KV heads split, int8) of each cell
LAYOUT = {(GEMMA, "long_500k"): (1, 524288 // 16, 16, False),
          (QWEN, "decode_32k"): (128 // 16, 32768 // 16, 1, True),
          (RG, "long_500k"): (1, 524288 // 32, 16, False)}


@pytest.mark.parametrize("cell", [c[:2] for c in CELLS])
def test_split_cache_cells_read_the_partitioned_step(cells, cell):
    """No ``"why"``: temp, alias and collectives are rank 0's, the cache
    written in place is the alias."""
    rec = cells[cell]
    mem, roof = rec["memory"], rec["roofline"]
    chips = 512 if rec["mesh"] == "2x16x16" else 256
    assert "why" not in mem and "why" not in roof
    assert isinstance(mem["temp_bytes"], int) and mem["temp_bytes"] > 0
    assert mem["alias_bytes"] == cache_bytes(cell[0], *LAYOUT[cell])
    kinds = roof["collective_by_kind"]
    assert set(kinds) <= {"all-gather", "reduce-scatter", "all-reduce"}
    assert kinds["all-reduce"] > 0
    assert sum(kinds.values()) == roof["collective_bytes"] == \
        chips * roof["collective_bytes_per_device"] > 0
    assert roof["t_collective_s"] == pytest.approx(
        roof["collective_bytes_per_device"] / 450e9, rel=1e-12)


def test_the_cache_bytes_of_the_three_cells():
    """The caches of the three cells, reckoned by hand: Qwen3's 28
    layers of 8 x 2,048 rows of 8 int8 KV heads with their scales,
    gemma3's 62 layers of 32,768 rows of one of its 16 KV heads,
    recurrentgemma's 12 attention layers of 16,384 rows of its one KV
    head (head_dim 256) beside 26 RG-LRU layers' states."""
    assert cache_bytes(QWEN, *LAYOUT[QWEN, "decode_32k"]) == \
        28 * (2 * 8 * 2048 * 8 * 128 + 2 * 8 * 2048 * 8 * 4 + 4)
    assert cache_bytes(GEMMA, *LAYOUT[GEMMA, "long_500k"]) == \
        62 * (2 * 32768 * 128 * 2 + 4)
    assert cache_bytes(RG, *LAYOUT[RG, "long_500k"]) == \
        12 * (2 * 16384 * 256 * 2 + 4) + 26 * (256 + 3 * 4096) * 4


# the reduced cells: Qwen3's decode step at long_500k's rules (batch 1,
# the cache on data) and at --optimized's (the cache on model, int8)
HLO_CELLS = {"long_500k": (1, 64),
             "decode_32k_opt": (4, 64, {"shape": "decode_32k", "int8": True,
                                        "rules": {"cache_seq": "model"}})}


@pytest.fixture(scope="module")
def against_hlo():
    return hlo_collectives(HLO_CELLS, HLO_KW)


def _lookup(cfg, batch: int):
    """The embedding lookup's named difference (``tests/
    test_torch_dryrun.py::test_collectives_against_the_reference_hlo``):
    the port gathers its table's shard over ``data``, the reference the
    token ids."""
    return cfg.vocab_size // 2 * cfg.d_model * 4, batch * 4


def test_optimized_decode_equals_the_reference_hlo(against_hlo):
    """The int8 cache on ``model``: the same bytes of each kind as the
    reference once two differences are set aside:

    * the embedding lookup (``_lookup``; the reference also lays the
      looked-up rows out by an all-to-all and a collective-permute);
    * the fresh K and V rows, gathered whole over ``model`` (their 2 KV
      heads split there, the cache's whole): the reference quantizes
      each rank's heads first and gathers the int8 values and float32
      scales, the port gathers the float32 rows and quantizes them
      whole.

    The query heads' gather over ``model`` and the merge's all-reduces
    (the running max; the rescaled accumulator beside the denominator)
    are what XLA's partitioned softmax moves too."""
    ref, port = (side["decode_32k_opt"] for side in against_hlo)
    cfg = reduced(get_config(QWEN)).replace(**HLO_KW)
    table, ids = _lookup(cfg, 4)
    n, b, kv, hd = cfg.n_layers, 4 // 2, cfg.n_kv_heads, cfg.hd
    fresh = n * 2 * b * kv * hd * 4                 # k and v, float32
    quantized = n * 2 * b * kv * (hd + 4)           # int8 and the scales
    assert set(port) == {"all-gather", "all-reduce"}
    assert port["all-gather"] - table - fresh == \
        ref["all-gather"] - ids - quantized
    assert port["all-reduce"] == ref["all-reduce"]
    assert ref["all-to-all"] == 2 * cfg.d_model * 4


def test_long_500k_moves_no_more_than_the_reference_hlo(against_hlo):
    """The cache on ``data`` at batch 1: after the lookup's difference,
    the port gathers and all-reduces no more than the reference.  With
    the batch whole, the port's FSDP products run row-parallel on
    ``data`` and all-reduce their one-token outputs, where the reference
    gathers the weights; the merge adds the running max and the
    rescaled sums of each layer's query heads (float32)."""
    ref, port = (side["long_500k"] for side in against_hlo)
    cfg = reduced(get_config(QWEN)).replace(**HLO_KW)
    table, ids = _lookup(cfg, 1)
    assert set(port) == {"all-gather", "all-reduce"}
    assert 0 < port["all-gather"] - table <= ref["all-gather"] - ids
    # the merge's all-reduces alone: each layer's local query heads' max,
    # and their head_dim sums beside the denominator
    heads = cfg.n_heads // 2
    merge = cfg.n_layers * heads * (1 + cfg.hd + 1) * 4
    assert merge < port["all-reduce"] <= ref["all-reduce"]

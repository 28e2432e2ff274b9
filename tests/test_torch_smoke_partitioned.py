"""Phase 24 of ``chip_smoke.py`` (``partitioned_slice``) rehearsed on the
CPU at reduced size over ``gloo`` and the ``fake`` group, with the CUDA
calls stubbed and the shapes of its cells cut, for its six configs:
Qwen3-0.6B (its vocabulary 512, so that it splits), granite-moe-1b (16
experts, so that each of the 16 data ranks of the ``fake`` mesh holds
one and the dispatch crosses by all-to-all), mamba2-130m (its 8 heads
whole on the 16-way ``model``, as the full config's 24 are; the conv's
160 channels split), recurrentgemma-9b at one period of 3 layers
(rnn 64, split 16 ways, so that r and i are reduce-scattered),
whisper-tiny (its 24 encoder frames, cross-attention and learned
positions; LayerNorm) and pixtral-12b at 4 layers (its 8 patches ahead
of the prompt).

* (a) the one-rank partitioned route bit-equal to the unpartitioned one
  leaf by leaf (the logits still laid out on the mesh, every parameter,
  gradient and moment placed), its launches -- counted by wrappers
  around the plain versions -- equal to that route's;
* (a) from the same placed weights, Qwen3 over an int8 cache on
  ``model`` and recurrentgemma over a cache on ``data`` with the batch
  whole (``PART_SPLIT``): the attention's merge over a group of one,
  held against the unpartitioned route;
* (b) the collectives rank 0's program issues on the CPU equal to the
  dry run's on the meta device, cell by cell, granite's train and
  prefill cells with their all-to-alls, mamba2's ``long_500k`` beside
  the three, and the caches split on the sequence: recurrentgemma's and
  gemma3-27b's (reduced) ``long_500k`` and Qwen3's ``decode_32k`` under
  ``--optimized``.

In a file of its own so that parallel workers take it apart from the
other helpers (``tests/test_torch_smoke_helpers.py``).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from test_torch_serve import _smoke  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

SMOKE = _smoke()

# the shapes of phase 24's cells cut for the CPU, their kinds kept
SMALL_CELLS = {"train_4k": (32, 64), "prefill_32k": (32, 128),
               "decode_32k": (128, 256), "long_500k": (1, 512)}
# the configs at the rehearsal's size: reduced, with the vocabulary split
# and one of granite's experts on each of 16 data ranks
SMALL = {"qwen3-0.6b": {"vocab_size": 512},
         "granite-moe-1b-a400m": {"vocab_size": 512, "n_experts": 16},
         "mamba2-130m": {"vocab_size": 512},
         "recurrentgemma-9b": {"vocab_size": 512},
         "whisper-tiny": {"vocab_size": 512},
         "pixtral-12b": {"vocab_size": 512},
         "gemma3-27b": {"vocab_size": 512}}


def small_config(full):
    def small(arch):
        return reduced(full(arch)).replace(**SMALL.get(arch, {}))
    return small


@pytest.fixture(scope="module")
def phase_24():
    with pytest.MonkeyPatch.context() as monkeypatch:
        yield _phase_24(monkeypatch)


def _phase_24(monkeypatch):
    """``partitioned_slice`` at reduced size on the CPU: the configs of
    ``SMALL``, the cells cut to ``SMALL_CELLS``, the dry-run records made
    in a process of their own, the CUDA calls stubbed, the kernels'
    plain versions counted as launches."""
    import repro_torch.configs as configs
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, shapes
    small = small_config(configs.get_config)
    monkeypatch.setattr(configs, "get_config", small)
    monkeypatch.setattr(dryrun, "get_config", small)
    for name, (batch, seq) in SMALL_CELLS.items():
        monkeypatch.setitem(shapes.SHAPES, name, dataclasses.replace(
            shapes.SHAPES[name], seq=seq, global_batch=batch))
    monkeypatch.setattr(SMOKE, "CARD", "cpu")
    monkeypatch.setattr(SMOKE, "PART_PREFILL", (2, 24))
    monkeypatch.setattr(SMOKE, "PART_TRAIN", (2, 16))
    for arch in ("MOE", "SSM", "RG", "WHISPER", "PIXTRAL"):
        monkeypatch.setattr(SMOKE, f"PART_{arch}_PREFILL", (2, 24))
        monkeypatch.setattr(SMOKE, f"PART_{arch}_TRAIN", (2, 16))
    # the CPU has no allocator peak to hold
    monkeypatch.setattr(SMOKE, "PART_PEAK_MARGIN_GB", float("inf"))
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: 0)
    monkeypatch.setattr(SMOKE, "start_fake_dryrun",
                        lambda arch, name, out_dir: (arch, name))

    # the dry run's records, each config's from a process of its own as
    # on the card (one default process group a process), at the same cut
    records = _small_records()
    monkeypatch.setattr(SMOKE, "fake_dryrun_record",
                        lambda proc, arch, name, out_dir: records[arch][name])
    for name, counter in SMOKE._counters().items():
        if name in ("matmul", "fused_add_rmsnorm", "flash_attention"):
            def counting(*a, _run=getattr(ops, name), _c=counter, **k):
                _c.launches += 1
                return _run(*a, **k)
            monkeypatch.setattr(ops, name, counting)
    report = {}
    got = SMOKE.partitioned_slice(torch.device("cpu"), "cpu", report)
    return got, report["partitioned"]


RECORDS = """
import dataclasses, json, sys
import repro_torch.configs as configs
from repro_torch.launch import dryrun, shapes
cells, arch, kw = (json.loads(a) for a in sys.argv[1:])
full = configs.get_config
small = lambda name: configs.reduced(full(name)).replace(**kw)
configs.get_config = dryrun.get_config = small
out = {}
with dryrun.fake_world(False):
    for name, (shape, optimized, batch, seq) in cells.items():
        shapes.SHAPES[shape] = dataclasses.replace(
            shapes.SHAPES[shape], seq=seq, global_batch=batch)
        rules, cfg = (dryrun.optimized_overrides(arch, shape)[:2]
                      if optimized else (None, None))
        out[name] = dryrun.lower_cell(arch, shape, False, rules, cfg)[0]
print("RECORDS " + json.dumps(out))
"""


def _small_records() -> dict:
    """Each config's records of its cells of ``SMALL_CELLS``, every
    config at once."""
    import json
    import subprocess
    import sys
    from test_torch_ranks import ROOT, env
    def cells(arch):
        return {n: [*SMOKE.cell_shape(n), *SMALL_CELLS[SMOKE.cell_shape(n)[0]]]
                for n in SMOKE.part_cells(arch)}
    procs = {arch: subprocess.Popen(
        [sys.executable, "-c", RECORDS, json.dumps(cells(arch)),
         json.dumps(arch), json.dumps(kw)], cwd=ROOT, env=env(), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for arch, kw in SMALL.items()}
    out = {}
    try:
        for arch, proc in procs.items():
            text, err = proc.communicate(timeout=300)
            lines = [ln for ln in text.splitlines()
                     if ln.startswith("RECORDS ")]
            assert lines, text[-2000:] + err[-3000:]
            out[arch] = json.loads(lines[-1][len("RECORDS "):])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def _leaves_held(arch, steps, layers=None):
    """The logits and the cache's leaves (an attention layer's k, v and
    positions, an SSD layer's state and conv tail, an RG-LRU layer's);
    the logits and tokens of each step; parameters, both moments, the
    optimizer's step, the gradients, the loss and the gradients' norm."""
    cfg = small_config(get_config)(arch)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    model = Model(cfg)
    n_params = len(list(SMOKE.leaf_items(model.param_defs())))
    n_cache = len(list(SMOKE.leaf_items(model.make_cache(1, 1,
                                                         abstract=True))))
    return {"prefill": 1 + n_cache, **{f"decode{i}": 2
                                       for i in range(steps)},
            "cache": n_cache, "step": 4 * n_params + 3}


def test_phase_24_one_rank_route_is_bit_equal(phase_24):
    got, out = phase_24
    one = out[SMOKE.PART_ARCH]["one_rank"]
    assert one["mesh"] == {"data": 1, "model": 1}
    assert one["leaves_held"] == _leaves_held(SMOKE.PART_ARCH,
                                              SMOKE.PART_DECODE_STEPS)
    assert one["placements"] == ["S(0)", "S(1)"]
    assert one["logits_local"] == [2, 512]
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_phase_24_moe_one_rank_route_is_bit_equal(phase_24):
    """granite's prefill, two decode steps and AdamW step under remat
    ``full``: every leaf bit-equal on one rank."""
    _, out = phase_24
    one = out[SMOKE.PART_MOE_ARCH]["one_rank"]
    assert one["arch"] == "granite-moe-1b-a400m"
    assert one["mesh"] == {"data": 1, "model": 1}
    assert one["leaves_held"] == _leaves_held(SMOKE.PART_MOE_ARCH,
                                              SMOKE.PART_MOE_DECODE_STEPS)
    assert one["logits_local"] == [2, 512]


def test_phase_24_launches_are_the_unpartitioned_routes(phase_24):
    got, out = phase_24
    cfg = reduced(get_config("qwen3-0.6b"))
    n = cfg.n_layers
    launches = out[SMOKE.PART_ARCH]["one_rank"]["launches"]
    # a prefill and each decode step: 7n + 1 GEMMs, 2n + 1 add+norms,
    # n attentions in the prefill only; the step under remat "full"
    assert launches["flash_attention"] >= 2 * n
    assert launches["matmul"] > (1 + SMOKE.PART_DECODE_STEPS) * (7 * n + 1)
    assert launches["bn_forward"] == launches["bn_backward"] == 0
    total = {}
    for arch in SMOKE.PART_ARCHS + ("gemma3-27b",):
        one = out[arch].get("one_rank", {})
        for part in (one, one.get("split", {}), out[arch]["fake"]):
            for name, n_ in part.get("launches", {}).items():
                total[name] = total.get(name, 0) + n_
    assert got["launches"] == total
    assert set(out) == set(SMOKE.PART_ARCHS) | {"gemma3-27b", "seconds"}


def test_phase_24_moe_launches_are_the_unpartitioned_routes(phase_24):
    """granite's experts run as many GEMMs on the partitioned route as on
    the unpartitioned one (held inside the phase): three a local expert
    and token pass, every expert local on one rank."""
    _, out = phase_24
    cfg = small_config(get_config)("granite-moe-1b-a400m")
    n = cfg.n_layers
    launches = out[SMOKE.PART_MOE_ARCH]["one_rank"]["launches"]
    # the prefill and each decode step: the router, 3 GEMMs an expert and
    # 4 attention products a layer, and the head
    assert launches["matmul"] > (1 + SMOKE.PART_MOE_DECODE_STEPS) * (
        (1 + 3 * cfg.n_experts + 4) * n + 1)
    assert launches["flash_attention"] >= 2 * n


@pytest.mark.parametrize("cell", sorted(SMOKE.PART_CELLS))
def test_phase_24_collectives_equal_the_dry_run(phase_24, cell):
    _, out = phase_24
    fake = out[SMOKE.PART_ARCH]["fake"][cell]
    read = fake["card_read"]
    assert read["collective_bytes"] > 0
    assert read["collective_by_kind"]["all-gather"] > 0
    assert fake["dry_argument_bytes"] > 0
    assert fake["temp_bytes"] > 0
    assert (fake["alias_bytes"] > 0) == (cell == "decode_32k")


@pytest.mark.parametrize("cell", sorted(SMOKE.PART_CELLS))
def test_phase_24_moe_collectives_equal_the_dry_run(phase_24, cell):
    """granite's cells (held equal to the dry run's inside the phase):
    train and prefill hold whole blocks a rank and exchange them by
    all-to-all; decode's blocks span 8 ranks and are reduce-scattered."""
    _, out = phase_24
    fake = out[SMOKE.PART_MOE_ARCH]["fake"][cell]
    kinds = fake["card_read"]["collective_by_kind"]
    assert (kinds.get("all-to-all", 0) > 0) == (cell != "decode_32k")
    assert kinds["reduce-scatter"] > 0
    assert fake["temp_bytes"] > 0
    assert (fake["alias_bytes"] > 0) == (cell == "decode_32k")


RECURRENT = {"mamba2-130m": ("SSM", None), "recurrentgemma-9b": ("RG", 3)}


@pytest.mark.parametrize("arch", sorted(RECURRENT))
def test_phase_24_recurrent_one_rank_route_is_bit_equal(phase_24, arch):
    """mamba2's and recurrentgemma's (one period, 3 layers) prefill, two
    decode steps and AdamW step under remat ``full``: every leaf
    bit-equal on one rank, each kernel's launches equal to the
    unpartitioned route's (held inside the phase)."""
    _, out = phase_24
    tag, layers = RECURRENT[arch]
    one = out[arch]["one_rank"]
    assert one["mesh"] == {"data": 1, "model": 1}
    assert one["layers"] == (layers or small_config(get_config)(
        arch).n_layers)
    assert one["leaves_held"] == _leaves_held(
        arch, getattr(SMOKE, f"PART_{tag}_DECODE_STEPS"), layers)
    assert one["logits_local"] == [2, 512]
    launches = one["launches"]
    assert launches["matmul"] > 0 and launches["fused_add_rmsnorm"] > 0
    assert (launches["flash_attention"] > 0) == (arch != "mamba2-130m")


@pytest.mark.parametrize("arch,cell", [
    (a, c) for a in sorted(RECURRENT) for c in sorted(SMALL_CELLS)
    if c != "long_500k" or a == "mamba2-130m"])
def test_phase_24_recurrent_collectives_equal_the_dry_run(phase_24, arch,
                                                          cell):
    """The recurrent configs' cells (held equal to the dry run's inside
    the phase): recurrentgemma reduce-scatters r and i in every cell;
    mamba2 gathers its conv weight (160 channels split 16 ways) and,
    with its heads whole, sums no norm over ``model``; the decode cells
    (mamba2's ``long_500k`` among them) write their caches in place."""
    _, out = phase_24
    fake = out[arch]["fake"][cell]
    kinds = fake["card_read"]["collective_by_kind"]
    assert kinds["all-gather"] > 0 and fake["temp_bytes"] > 0
    if arch == "recurrentgemma-9b":
        assert kinds["reduce-scatter"] > 0
    assert (fake["alias_bytes"] > 0) == (cell in ("decode_32k",
                                                  "long_500k"))


FRONT_ENDS = {"whisper-tiny": ("WHISPER", None), "pixtral-12b": ("PIXTRAL", 4)}


@pytest.mark.parametrize("arch", sorted(FRONT_ENDS))
def test_phase_24_frontend_one_rank_route_is_bit_equal(phase_24, arch):
    """whisper's (its frames through the encoder, the cross-attention
    cache and the learned positions' offset among the leaves) and
    pixtral's (4 layers, its patches ahead of the prompt) prefill, two
    decode steps and AdamW step under remat ``full``: every leaf
    bit-equal on one rank, each kernel's launches equal to the
    unpartitioned route's (held inside the phase); whisper, a LayerNorm
    config, launches no fused add+norm."""
    _, out = phase_24
    tag, layers = FRONT_ENDS[arch]
    one = out[arch]["one_rank"]
    assert one["mesh"] == {"data": 1, "model": 1}
    assert one["layers"] == (layers or small_config(get_config)(
        arch).n_layers)
    assert one["leaves_held"] == _leaves_held(
        arch, getattr(SMOKE, f"PART_{tag}_DECODE_STEPS"), layers)
    assert one["logits_local"] == [2, 512]
    launches = one["launches"]
    assert launches["matmul"] > 0 and launches["flash_attention"] > 0
    assert (launches["fused_add_rmsnorm"] > 0) == (arch == "pixtral-12b")


@pytest.mark.parametrize("arch,cell", [
    (a, c) for a in sorted(FRONT_ENDS) for c in sorted(SMOKE.PART_CELLS)])
def test_phase_24_frontend_collectives_equal_the_dry_run(phase_24, arch,
                                                         cell):
    """The front-end configs' cells (held equal to the dry run's inside
    the phase, their train and prefill steps fed frames or patches): the
    decode cells write their caches in place, whisper's cross-attention
    K/V only read."""
    _, out = phase_24
    fake = out[arch]["fake"][cell]
    kinds = fake["card_read"]["collective_by_kind"]
    assert kinds["all-gather"] > 0 and fake["temp_bytes"] > 0
    assert (fake["alias_bytes"] > 0) == (cell == "decode_32k")


SPLIT = {"qwen3-0.6b": (torch.int8, 5), "recurrentgemma-9b": (None, 3)}


@pytest.mark.parametrize("arch", sorted(SPLIT))
def test_phase_24_split_caches_hold_against_the_unpartitioned_route(
        phase_24, arch):
    """(a)'s split layouts from the weights already placed: Qwen3 with an
    int8 cache on ``model`` (its attention leaves k, v, their scales and
    the positions), recurrentgemma with its cache on ``data`` and the
    batch whole; the prefill's logits and cache bit-equal, the decode
    steps within the serving gate on the unpartitioned route's tokens,
    and the launches the unpartitioned route's (held inside the phase)."""
    _, out = phase_24
    split = out[arch]["one_rank"]["split"]
    dtype, attn_leaves = SPLIT[arch]
    cfg = small_config(get_config)(arch)
    if arch == "recurrentgemma-9b":
        cfg = cfg.replace(n_layers=3)
    cache = Model(cfg.replace(cache_dtype=dtype)).make_cache(
        1, 1, abstract=True)
    assert split["prefill_cache_leaves_equal"] == len(list(
        SMOKE.leaf_items(cache)))
    assert [len(c) for c in cache.values() if "k" in c] == [attn_leaves]
    assert split["logits_bit_equal"][0]
    assert len(split["logits_row_rel"]) == 1 + SMOKE.PART_DECODE_STEPS
    assert max(split["logits_row_rel"]) <= split["limit"]
    assert split["launches"]["flash_attention"] > 0


@pytest.mark.parametrize("arch,cell", [("gemma3-27b", "long_500k"),
                                       ("recurrentgemma-9b", "long_500k"),
                                       ("qwen3-0.6b", "decode_32k.opt")])
def test_phase_24_split_cells_equal_the_dry_run(phase_24, arch, cell):
    """(b)'s caches split on the sequence (held equal to the dry run's
    inside the phase): each decode step merges its attention across the
    cache's sequence axis by all-reduces and writes its cache in
    place."""
    _, out = phase_24
    fake = out[arch]["fake"][cell]
    kinds = fake["card_read"]["collective_by_kind"]
    assert kinds["all-reduce"] > 0 and fake["temp_bytes"] > 0
    assert fake["alias_bytes"] > 0

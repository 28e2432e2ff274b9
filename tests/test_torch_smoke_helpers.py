"""Helpers of ``chip_smoke.py``'s phases 18-21, on the CPU (where
``kernels.ops`` runs the plain versions):

* ``conditioned`` rescales every attention's projections -- self-,
  cross- and an encoder's -- and nothing else;
* ``first_layers`` cuts a stacked parameter tree to whole periods of
  the pattern, and ``to_float`` converts a tree in place;
* ``hold_encoder_attention`` holds a non-causal attention call against
  float64 and its zero-padded control fails the limit;
* ``step_errors`` reads relative errors leaf by leaf from host copies;
* ``scripts/saved_activations.py`` counts a step's saved bytes on the
  meta device;
* phase 21: ``_quant_slices`` keeps a leaf's ends block-aligned,
  ``moe_f32_reckoning`` counts llama4's float32 MoE layer on the meta
  device, the whole phase (``llama4_slice``) runs at reduced size with
  the CUDA calls stubbed, and ``--phases 21`` without a card exits
  non-zero and prints no result;
* phase 19's remat model (granite under ``full``: its run, held step,
  step under each policy and timing) at reduced size, the CUDA calls
  stubbed;
* phase 24 (``partitioned_slice``) at reduced size over ``gloo`` and the
  ``fake`` group with the CUDA calls stubbed and the shapes of its three
  cells cut: (a) the one-rank partitioned route bit-equal to the
  unpartitioned one leaf by leaf (the logits still laid out on the
  mesh, every parameter, gradient and moment placed), its launches --
  counted by wrappers around the plain versions -- equal to that
  route's; (b) the collectives rank 0's program issues on the CPU equal
  to the dry run's on the meta device, cell by cell; ``same_tree``
  failing a leaf that differs by one bit; and ``--phases 24`` without a
  card exiting non-zero.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from test_torch_serve import _smoke  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

SMOKE = _smoke()


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setattr(SMOKE, "CARD", "cpu")


def _params(arch, **kw):
    cfg = reduced(get_config(arch)).replace(**{"dtype": torch.float32,
                                               **kw})
    return cfg, Model(cfg).init(torch.Generator().manual_seed(0))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ["whisper-tiny", "recurrentgemma-9b",
                                  "granite-moe-1b-a400m", "mamba2-130m"])
def test_conditioned_rescales_every_attention_and_nothing_else(arch):
    cfg, params = _params(arch)
    got = dict(_paths(SMOKE.conditioned(params)))
    scaled = 0
    for name, w in _paths(params):
        leaf = name.rsplit("/", 1)[1]
        if leaf in ("wq", "wk", "wv", "wo") and "attn" in name:
            factor = (math.sqrt(w.shape[-2] / w.shape[-3]) if leaf != "wo"
                      else 1 / math.sqrt(w.shape[-3]))
            torch.testing.assert_close(got[name], w * factor)
            scaled += 1
        else:
            assert got[name] is w, name
    # the stacked wq, wk, wv, wo of each attention pattern position
    # (whisper: self-, cross- and the encoder's), and of each unrolled
    # remainder layer with attention
    kinds = cfg.pattern + tuple(cfg.pattern[:cfg.n_layers % len(cfg.pattern)])
    want = 4 * sum(k.startswith("attn") for k in kinds)
    if cfg.encoder_layers:
        want += 8
    assert scaled == want


def test_conditioned_whisper_covers_cross_and_encoder_attention():
    _, params = _params("whisper-tiny")
    got = SMOKE.conditioned(params)
    for path in (("blk0", "attn"), ("blk0", "xattn"), ("enc", "blk", "attn")):
        a, b = params, got
        for key in path:
            a, b = a[key], b[key]
        assert not torch.equal(a["wq"], b["wq"]), path


def test_first_layers_and_to_float():
    cfg, params = _params("recurrentgemma-9b", dtype=torch.bfloat16)
    assert cfg.n_layers == 7 and "rem0" in params
    cut = SMOKE.first_layers(params, cfg, 3)
    assert cut is params and not any(k.startswith("rem") for k in cut)
    whole = Model(cfg).init(torch.Generator().manual_seed(0))
    for name, leaf in _paths(cut):
        if name.startswith("/blk"):
            assert leaf.shape[0] == 1
            src = dict(_paths(whole))[name]
            assert torch.equal(leaf, src[:1])
    SMOKE.to_float(cut)
    assert all(leaf.dtype == torch.float32 for _, leaf in _paths(cut))
    small = cfg.replace(n_layers=3, dtype=torch.float32)
    logits, _, _ = Model(small).forward(cut, torch.zeros((1, 4),
                                                         dtype=torch.int64))
    assert logits.shape == (1, 4, cfg.vocab_size)
    with pytest.raises(AssertionError):
        SMOKE.first_layers(Model(cfg).init(torch.Generator().manual_seed(0)),
                           cfg, 4)


@pytest.mark.parametrize("s", [100, 1500])
def test_encoder_hold_passes_the_plain_attention_and_fails_padding(s):
    """float32: on the CPU the call runs the plain version, which in
    bf16 is not the kernel's arithmetic (it rounds the probabilities and
    sums in bf16 there)."""
    gen = torch.Generator().manual_seed(3)
    h = 6
    q, k, v = (torch.randn((h, s, 64), generator=gen) for _ in range(3))
    out = SMOKE.hold_encoder_attention((q, k, v, h, h))
    assert out["padded_keys"] == (-s) % 512
    assert out["row_rel"] <= SMOKE.ENCODER_ROW_REL < out["control_row_rel"]


def test_step_errors_from_host_copies(on_cpu):
    want = {"loss": 2.0, "grad_norm": 4.0,
            "grads": {"a": torch.ones(3, 5), "b": torch.full((7,), 2.0)},
            "params": {"a": torch.ones(3, 5), "b": torch.ones(7)}}
    got = {"loss": 2.0 * (1 + 1e-7), "grad_norm": 4.0,
           "grads": {"a": torch.ones(3, 5) * 1.01, "b": torch.full((7,), 2.0)},
           "params": {"a": torch.ones(3, 5), "b": torch.ones(7) * 0.5}}
    e = SMOKE.step_errors(got, want)
    assert e["loss"] == pytest.approx(1e-7) and e["grad_norm"] == 0.0
    assert e["grad"] == pytest.approx(0.01) and e["grad_worst"] == "a"
    assert e["param"] == pytest.approx(0.5) and e["param_worst"] == "b"
    assert SMOKE.rel_fro(torch.zeros(4), torch.zeros(4)) == 0.0


def test_saved_activations_script_counts_on_the_meta_device():
    """``scripts/saved_activations.py``: a step's saved bytes grow with
    the batch, the plain route saves attention's probabilities beside
    the kernel route's inputs, and AdamW's state is 16 bytes a
    parameter."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "saved_activations.py"
    spec = importlib.util.spec_from_file_location("saved_activations", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    one = script.saved_bytes("smollm-360m", 1, 1, 64, plain=False)
    two = script.saved_bytes("smollm-360m", 1, 2, 64, plain=False)
    plain = script.saved_bytes("smollm-360m", 1, 1, 64, plain=True)
    assert 0 < one["saved_gb"] < two["saved_gb"] <= 2 * one["saved_gb"]
    assert plain["saved_gb"] > one["saved_gb"]
    assert one["adamw_state_gb"] == 16 * one["params"] / 1e9
    assert one["largest"] and one["route"] == "kernels"


# ---- phase 21 ------------------------------------------------------------------

def test_quant_slices_keep_block_aligned_ends(monkeypatch):
    monkeypatch.setattr(SMOKE, "QUANT_SLICE", 1024)
    assert SMOKE._quant_slices(2048) == [(0, 2048)]
    assert SMOKE._quant_slices(5000) == [(0, 1024), (3840, 5000)]
    for a, b in SMOKE._quant_slices(10 ** 6 + 7):
        assert a % 256 == 0 and b - a >= 1024


def test_moe_f32_reckoning_of_llama4_at_full_width():
    cfg = get_config("llama4-maverick-400b-a17b").replace(
        dtype=torch.float32)
    got = SMOKE.moe_f32_reckoning(cfg, 2048)
    assert got["params"] == 16_232_611_840
    assert got["weights_gb"] == pytest.approx(64.93, abs=0.01)
    # the most held at once (``StepReader``'s peak): 0.40 GB
    assert 0.2 < got["activations_gb"] < 2.0
    assert got["total_gb"] < 70


class _Event:
    def __init__(self, **kw):
        self.t = 0.0

    def record(self):
        import time
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_phase_21_rehearsed_on_the_cpu(monkeypatch):
    """``llama4_slice`` end to end at reduced size on the CPU: the CUDA
    calls stubbed, the launch counters (which a plain version never
    touches) not held, the one-rank mesh over ``gloo``."""
    import repro_torch.configs as configs
    full = configs.get_config
    monkeypatch.setattr(configs, "get_config",
                        lambda arch: reduced(full(arch)))
    monkeypatch.setattr(SMOKE, "CARD", "cpu")
    monkeypatch.setattr(SMOKE, "LLAMA4", SMOKE.LLAMA4._replace(
        gen=2, batch=2, prompt=12))
    monkeypatch.setattr(SMOKE, "LLAMA4_F32_TOKENS", 24)
    monkeypatch.setattr(SMOKE, "QUANT_SLICE", 512)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda *a: (60e9, 80e9))
    monkeypatch.setattr(SMOKE, "counted", lambda what, fn, want, route: (
        fn(), dict(want), {"wgmma": 0, "mma": want.get("matmul", 0)}))
    report = {}
    got = SMOKE.llama4_slice(torch.device("cpu"), "cpu", report)
    cfg = reduced(full("llama4-maverick-400b-a17b")).replace(n_layers=2)
    step = SMOKE.serve_launches(cfg, False)
    assert got["launches"] == {k: SMOKE.serve_launches(cfg, True)[k]
                               + 2 * step[k] for k in step}
    assert set(got["held"]) == {"matmul", "fused_add_rmsnorm",
                                "flash_attention"}
    out = report["llama4"]
    assert "more" not in out["serve"]     # phase 24 runs the mesh now
    assert out["compression"]["held_elements_cpu"] > 0
    assert out["moe_f32"]["max_abs"] <= SMOKE.SERVE_F32_ABS
    assert out["moe_f32"]["bf16_control_max_abs"] > SMOKE.SERVE_F32_ABS
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_phase_19_remat_model_rehearsed_on_the_cpu(monkeypatch):
    """``training_mixers_slice`` for granite under remat at reduced size
    on the CPU: the CUDA calls, the profiler and the launch reckoning
    stubbed (a plain version touches no counter), the meta reckoning run
    in this process.  Its run, held step and control, its step under
    each policy (gradients bit-equal, one recompute a group) and both
    routes' timing run through."""
    import repro_torch.configs as configs
    import repro_torch.launch.train as train
    full = configs.get_config
    for module in (configs, train):   # train_loop's own reference too
        monkeypatch.setattr(module, "get_config",
                            lambda arch: reduced(full(arch)))
    monkeypatch.setattr(SMOKE, "CARD", "cpu")
    monkeypatch.setattr(SMOKE, "MIXER_TRAIN",
                        (("granite-moe-1b-a400m", None, 2, 32, "full"),))
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache",
                 "_sleep"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    none = dict.fromkeys(("matmul", "fused_add_rmsnorm", "flash_attention"),
                         0)
    monkeypatch.setattr(SMOKE, "train_launches", lambda cfg: dict(none))
    monkeypatch.setattr(SMOKE, "counted", lambda what, fn, want, route: (
        fn(), dict(want), {"wgmma": 0, "mma": want.get("matmul", 0)}))
    monkeypatch.setattr(SMOKE, "profile_phases", lambda fn: (fn(), {
        "device_ms": 1.0, "phases": None, "records": [0],
        "recompute_device_ms": 0.0})[1])
    made = {}

    def reckon(arch, policy, batch, seq, path):
        made["cfg"] = reduced(full(arch)).replace(
            dtype=torch.float32, remat=True, remat_policy=policy)
        return batch, seq
    monkeypatch.setattr(SMOKE, "start_train_reckoning", reckon)
    monkeypatch.setattr(SMOKE, "train_reckoning", lambda proc, path: (
        SMOKE.dry_reckoning(made["cfg"], "train", *proc)))
    report = {}
    got = SMOKE.training_mixers_slice(torch.device("cpu"), "cpu", report)
    out = report["training_mixers"]["granite-moe-1b-a400m"]
    assert set(out["policies"]) == set(SMOKE.REMAT_POLICIES)
    cfg = reduced(full("granite-moe-1b-a400m"))
    for policy, rec in out["policies"].items():
        assert rec["recomputes"] == cfg.n_layers
        assert rec.get("grads_bit_equal", True)
    assert out["reckoning"]["total_gb"] > out["reckoning"]["state_gb"] > 0
    assert len(out["losses"]) == out["steps"] == 2
    off = out["remat_off"]
    assert len(off["losses"]) == SMOKE.REMAT_OFF_STEPS
    assert off["steps"]["grads_bit_equal"]
    assert set(off["steps"]) == {"off", "full", "grads_bit_equal"}
    assert out["step_vs_plain"]["grad"] <= SMOKE.LLM_STEP_REL["grad"]
    assert set(got["held"]) == {"matmul", "fused_add_rmsnorm",
                                "flash_attention"}


def test_phases_21_without_a_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert SMOKE.main(["--phases", "21"]) == 1
    assert '"ok"' not in capsys.readouterr().out


# ---- phase 24 --------------------------------------------------------------

# the shapes of phase 24's cells cut for the CPU, their kinds kept
SMALL_CELLS = {"train_4k": (32, 64), "prefill_32k": (32, 128),
               "decode_32k": (128, 256)}


@pytest.fixture(scope="module")
def phase_24():
    with pytest.MonkeyPatch.context() as monkeypatch:
        yield _phase_24(monkeypatch)


def _phase_24(monkeypatch):
    """``partitioned_slice`` at reduced size on the CPU: Qwen3 reduced
    (its vocabulary 512, so that it splits), the cells cut to
    ``SMALL_CELLS``, the dry-run records made in a process of their
    own, the CUDA calls stubbed, the kernels' plain versions counted as
    launches."""
    import repro_torch.configs as configs
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, shapes
    full = configs.get_config

    def small(arch):
        return reduced(full(arch)).replace(vocab_size=512)
    monkeypatch.setattr(configs, "get_config", small)
    monkeypatch.setattr(dryrun, "get_config", small)
    for name, (batch, seq) in SMALL_CELLS.items():
        monkeypatch.setitem(shapes.SHAPES, name, dataclasses.replace(
            shapes.SHAPES[name], seq=seq, global_batch=batch))
    monkeypatch.setattr(SMOKE, "CARD", "cpu")
    monkeypatch.setattr(SMOKE, "PART_PREFILL", (2, 24))
    monkeypatch.setattr(SMOKE, "PART_TRAIN", (2, 16))
    # the CPU has no allocator peak to hold
    monkeypatch.setattr(SMOKE, "PART_PEAK_MARGIN_GB", float("inf"))
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: 0)
    monkeypatch.setattr(SMOKE, "traced_device_ms", lambda fn: (None, 0))
    monkeypatch.setattr(SMOKE, "start_fake_dryrun",
                        lambda arch, name, out_dir: (arch, name))

    # the dry run's records, each from a process of its own as on the card
    # (one default process group a process), at the same cut
    records = _small_records()
    monkeypatch.setattr(SMOKE, "fake_dryrun_record",
                        lambda proc, arch, name, out_dir: records[name])
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
cells = json.loads(sys.argv[1])
full = configs.get_config
small = lambda arch: configs.reduced(full(arch)).replace(vocab_size=512)
configs.get_config = dryrun.get_config = small
for name, (batch, seq) in cells.items():
    shapes.SHAPES[name] = dataclasses.replace(shapes.SHAPES[name], seq=seq,
                                              global_batch=batch)
with dryrun.fake_world(False):
    out = {name: dryrun.lower_cell("qwen3-0.6b", name, False)[0]
           for name in cells}
print("RECORDS " + json.dumps(out))
"""


def _small_records() -> dict:
    import json
    import subprocess
    import sys
    from test_torch_ranks import ROOT, env
    res = subprocess.run([sys.executable, "-c", RECORDS,
                          json.dumps(SMALL_CELLS)], cwd=ROOT, env=env(),
                         capture_output=True, text=True, timeout=300)
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith("RECORDS ")]
    assert lines, res.stdout[-2000:] + res.stderr[-3000:]
    return json.loads(lines[-1][len("RECORDS "):])


def test_phase_24_one_rank_route_is_bit_equal(phase_24):
    got, out = phase_24
    one = out["one_rank"]
    assert one["mesh"] == {"data": 1, "model": 1}
    n_params = len(list(SMOKE.leaf_items(Model(reduced(get_config(
        "qwen3-0.6b"))).param_defs())))
    # the logits and the cache's k, v and positions; the logits and
    # tokens of each step; parameters, both moments, the optimizer's
    # step, the gradients, the loss and the gradients' norm
    assert one["leaves_held"] == {
        "prefill": 4, **{f"decode{i}": 2 for i in range(
            SMOKE.PART_DECODE_STEPS)}, "cache": 3,
        "step": 4 * n_params + 3}
    assert one["placements"] == ["S(0)", "S(1)"]
    assert one["logits_local"] == [2, 512]
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_phase_24_launches_are_the_unpartitioned_routes(phase_24):
    got, out = phase_24
    cfg = reduced(get_config("qwen3-0.6b"))
    n = cfg.n_layers
    launches = out["one_rank"]["launches"]
    # a prefill and each decode step: 7n + 1 GEMMs, 2n + 1 add+norms,
    # n attentions in the prefill only; the step under remat "full"
    assert launches["flash_attention"] >= 2 * n
    assert launches["matmul"] > (1 + SMOKE.PART_DECODE_STEPS) * (7 * n + 1)
    assert launches["bn_forward"] == launches["bn_backward"] == 0
    for name, n_ in out["fake"]["launches"].items():
        assert got["launches"][name] == launches[name] + n_


@pytest.mark.parametrize("cell", sorted(SMALL_CELLS))
def test_phase_24_collectives_equal_the_dry_run(phase_24, cell):
    _, out = phase_24
    read = out["fake"][cell]["card_read"]
    assert read["collective_bytes"] > 0
    assert read["collective_by_kind"]["all-gather"] > 0
    assert out["fake"][cell]["dry_argument_bytes"] > 0
    assert out["fake"][cell]["temp_bytes"] > 0
    assert (out["fake"][cell]["alias_bytes"] > 0) == (cell == "decode_32k")


def test_same_tree_fails_a_flipped_bit():
    want = {"a": torch.ones(3), "b": {"c": torch.zeros(2)}}
    assert SMOKE.same_tree("t", {"a": torch.ones(3), "b": {
        "c": torch.zeros(2)}}, want) == 2
    flipped = torch.ones(3)
    flipped.view(torch.int32)[1] ^= 1
    with pytest.raises(AssertionError, match="/a"):
        SMOKE.same_tree("t", {"a": flipped, "b": {"c": torch.zeros(2)}},
                        want)


def test_phases_24_without_a_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert SMOKE.main(["--phases", "24"]) == 1
    assert '"ok"' not in capsys.readouterr().out

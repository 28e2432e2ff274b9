"""Helpers of ``chip_smoke.py``'s phases 18-24, on the CPU (where
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
* ``same_tree`` failing a leaf that differs by one bit and ``--phases
  24`` without a card exiting non-zero.

Phase 19's remat model and phase 24 are rehearsed in files of their own
(``tests/test_torch_smoke_training.py``,
``tests/test_torch_smoke_partitioned.py``), so that parallel workers
take them apart.
"""
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


def test_phases_21_without_a_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert SMOKE.main(["--phases", "21"]) == 1
    assert '"ok"' not in capsys.readouterr().out


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

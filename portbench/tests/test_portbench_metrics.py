"""The metric arithmetic on synthetic traces and timings."""
from __future__ import annotations

import math

import pytest

from portbench import check, gen, readings, roofline, spec, trace
from portbench.kinds.prefill import MAX_BATCH, plan, schedule
from portbench.run import loaded_forbidden

US = 1000  # ns


def synthetic():
    """A 100 us window: device records at 10-30 (a GEMM), 20-40 (plain:
    overlaps the GEMM), 60-70 (batch norm); the host in ``aten::copy_``
    over 40-60 and nothing over 70-100."""
    host = [(trace.SEGMENT, 0, 100 * US), ("aten::copy_", 35 * US, 62 * US),
            ("aten::mm", 0, 9 * US)]
    device = [("void mm_wgmma<128>(...)", 10 * US, 30 * US),
              ("elementwise_kernel", 20 * US, 40 * US),
              ("bn_forward_kernel<float>", 60 * US, 70 * US),
              ("outside", 200 * US, 210 * US)]
    return trace.reduce(device, host)


def test_idle_is_one_less_the_union_of_device_intervals():
    r = synthetic()
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(40e-6)       # 10-40 and 60-70
    assert readings.idle_pct(dict(r)) == pytest.approx(60.0)
    assert r["records"] == 3                          # "outside" is outside


def test_idle_gaps_named_by_the_host():
    gaps = dict(synthetic()["idle_gaps"])
    assert gaps["aten::mm"] == pytest.approx(10e-6)   # 0-10
    assert gaps["aten::copy_"] == pytest.approx(20e-6)  # 40-60
    assert gaps["idle"] == pytest.approx(30e-6)       # 70-100


def test_device_time_by_group_and_shares():
    r = synthetic()
    assert r["group_s"] == pytest.approx({"matmul": 20e-6, "plain": 20e-6,
                                          "bn_forward": 10e-6})
    assert readings.plain_pct(r) == pytest.approx(40.0)
    assert readings.nonconv_pct(r) == pytest.approx(60.0)
    assert r["device_ops"][0][1] == pytest.approx(20e-6)
    r.update(units=2)
    assert readings.launches(r) == 1.5


def test_roofline_share_names_its_bound():
    # a square bf16 GEMM: 2n^3 operations dominate its 3n^2 x 2 bytes
    n = 4096
    flops, nbytes = roofline.work("matmul", ((n, n), (n, n)), "bfloat16")
    assert flops == 2 * n ** 3 and nbytes == 3 * n * n * 2
    t, what = roofline.least_seconds(flops, nbytes, "bfloat16")
    assert what == "operations" and t == pytest.approx(flops / 989e12)
    share, what = roofline.share([(flops, nbytes, "bfloat16", 2 * t)])
    assert share == pytest.approx(50.0) and what == "operations"
    # batch norm moves bytes
    f, b = roofline.work("bn_forward", ((401408, 64),), "float32")
    assert roofline.least_seconds(f, b, "float32")[1] == "bytes"
    assert math.isnan(roofline.share([])[0])


def test_causal_attention_counts_the_triangle():
    full = roofline.work("flash_attention", ((4, 8, 64), (2, 8, 64)),
                         "bfloat16", causal=False)[0]
    causal = roofline.work("flash_attention", ((4, 8, 64), (2, 8, 64)),
                           "bfloat16", causal=True)[0]
    assert full == 4 * 4 * 64 * 64 and causal == full * 36 / 64


def test_roofline_reading_over_recorded_calls():
    r = {"calls": [("matmul", ((64, 64), (64, 64)), "bfloat16", True, 1e-3),
                   ("bn_forward", ((64, 8), (8,), (8,)), "float32", True,
                    1e-3)]}
    got = readings.roofline_pct(r, ("matmul",))
    want = 100 * max(2 * 64 ** 3 / 989e12, 3 * 64 * 64 * 2 / 3.35e12) / 1e-3
    assert got == pytest.approx(want)
    assert readings.roofline_pct(r, ("flash_attention",)) is None


def test_training_gaps_take_the_worst_kept_leaf():
    want = {"losses": [2.0, 1.0], "grad_norms": {"a": 1.0, "b": 2.0,
                                                  "tiny": 1e-9},
            "change_norms": {"a": 1.0, "b": 4.0, "tiny": 5.0}}
    got = {"losses": [2.2, 1.0], "grad_norms": {"a": 1.1, "b": 2.0,
                                                 "tiny": 1.0},
           "change_norms": {"a": 1.0, "b": 3.0, "tiny": 0.0}}
    n = check.training(got, want)
    assert n["loss"] == pytest.approx(0.1)
    # against max(own, median of kept leaves = 1.5)
    assert n["grad_norm"] == pytest.approx(0.1 / 1.5)
    assert n["change_norm"] == pytest.approx(1.0 / 4.0)


def test_unchanged_state_reads_one():
    want = {"losses": [1.0], "grad_norms": {"a": 1.0},
            "change_norms": {"a": 3.0}}
    got = {"losses": [1.0], "grad_norms": {"a": 1.0},
           "change_norms": {"a": 0.0}}
    assert check.training(got, want)["change_norm"] == 1.0


def test_held_needs_every_number_under_its_limit():
    assert check.held({"a": 1.0}, {"a": 1.0})
    assert not check.held({"a": 1.1}, {"a": 1.0})
    assert not check.held({"a": float("nan")}, {"a": 1.0})
    assert not check.held({"a": 0.0}, {"a": 1.0, "b": 1.0})


def test_loaded_forbidden_compares_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType(
        "repro_torch_like"))
    assert "repro_torch_like" not in loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jaxlib.version", types.ModuleType(
        "jaxlib.version"))
    assert "jaxlib" in loaded_forbidden()


def test_plan_serves_each_request_once_after_it_is_due():
    mix = spec.cell("smollm-360m.prefill_over").mix
    due, lengths = schedule(mix, 10.0)
    batches = plan(due, lengths)
    assert batches == plan(due, lengths)
    served = [r for _, rows in batches for r in rows]
    assert sorted(served) == list(range(len(due)))
    assert [c for c, _ in batches] == sorted(c for c, _ in batches)
    for close, rows in batches:
        # full, of one length, closing when its last request is due
        assert len(rows) == MAX_BATCH and rows == sorted(rows)
        assert len({lengths[r] for r in rows}) == 1
        assert close == due[rows[-1]] == max(due[r] for r in rows)


def test_breakdown_names_drop_namespaces():
    name = ("void (anonymous namespace)::bn_forward_kernel<float, 4>"
            "(float const*, at::native::Layout)")
    assert trace.short(name) == "bn_forward_kernel<float, 4>(float const*, " \
        "Layout)"
    assert len(trace.short("void " + "x" * 900)) == trace.SHORT

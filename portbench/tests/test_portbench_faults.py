"""A run's check against what breaks it, at CPU size: the whole run but
the look for a card (``run.run_cell`` on the CPU, tiny cells in float32),
sound, then with each fault a cell can have planted in the program
underneath (``faults.py``), and the control (the reference computed with
products one precision below the configuration's in the program's
place) held to fail the cell's limits."""
from __future__ import annotations

import math

import pytest
import torch

from portbench import check, faults, gen, spec
from portbench.calibrate import control_numbers
from portbench.kinds.prefill import MAX_BATCH, SCHEDULE_SEED, schedule
from portbench.run import run_cell
from portbench.tests import tiny

WORKLOADS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 2 ** 34 + 5           # past 32 bits, as the driver's are
SECONDS = 0.3


def _run(name):
    return run_cell(tiny.cell(name), SEED, SECONDS, False, "cpu")


@pytest.mark.parametrize("name", WORKLOADS)
def test_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in
                                   spec.cell(name).end_to_end}


CASES = [(w, f) for w in WORKLOADS
         for f in faults.faults_of(spec.cell(w).mix["kind"])]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_makes_the_run_incorrect(name, fault):
    c = spec.cell(name)
    with faults.planted(fault, c.config["family"], c.mix["kind"]):
        out = _run(name)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", WORKLOADS)
def test_control_fails_the_limits(name):
    c = tiny.cell(name, own_precision=True)
    numbers = control_numbers(c, SEED, "cpu", SECONDS)
    assert not check.held(numbers, c.check["limits"]), numbers


@pytest.mark.parametrize("name", WORKLOADS)
def test_setup_parts_add_up_to_setup_s(name):
    out = _run(name)
    parts = out["setup_parts"]
    assert list(parts) == ["start", "cuda", "inputs", "program", "warm-up"]
    assert all(v >= 0 for v in parts.values())
    assert sum(parts.values()) == pytest.approx(
        out["metrics"]["setup_s"]["value"])


def test_traced_run_reads_its_metrics_on_the_cpu():
    out = run_cell(tiny.cell("smollm-360m.train"), SEED, SECONDS, True,
                   "cpu")
    assert out["correct"] and "mfu.train" in out["metrics"]
    assert out["trace"]["window_s"] > 0


def test_every_run_gets_the_mix_schedule():
    mix = spec.cell("smollm-360m.prefill_over").mix
    due, lengths = schedule(mix, 10.0)
    assert (due, lengths) == schedule(mix, 10.0)
    whole = MAX_BATCH * len(mix["lengths"])
    n = len(due)
    assert n % whole == 0 and abs(n - mix["rate_per_s"] * 10) <= whole / 2
    assert len(lengths) == n and due[0] == 0.0
    assert max(due) < 10.0 and due == sorted(due)
    counts = [lengths.count(x) for x in mix["lengths"]]
    assert sum(counts) == n and max(counts) == min(counts)
    other = gen.arrivals(mix, 10.0, SCHEDULE_SEED + 1, whole)
    assert sorted(other[1]) == sorted(lengths) and other[1] != lengths
    gaps = sorted(b - a for a, b in zip(due, due[1:]))
    assert gaps[len(gaps) // 2] == pytest.approx(
        math.log(2) / mix["rate_per_s"], rel=0.05)


def test_inputs_repeat_from_the_seed():
    c = tiny.cell("resnet50.train")
    one = gen.pool(c.config, c.mix, -7, "cpu")
    two = gen.pool(c.config, c.mix, -7, "cpu")
    assert all(torch.equal(a[0], b[0]) for a, b in zip(one, two))
    assert not torch.equal(one[0][0], one[1][0])

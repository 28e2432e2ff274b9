"""``BENCHMARK.json`` against the benchmark's contract, and every cell,
mix, configuration, limit and metric reader found by its name."""
from __future__ import annotations

import json
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert PATH.match(p) and ".." not in p and not p.startswith("/")
        assert (spec.ROOT / p).is_dir()


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and c["name"] in used
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert c["file"] not in files
        files.add(c["file"])
        data = spec.load_json(spec.ROOT / c["file"])
        assert data["source"] == c["source"]
        assert sorted(data["reduced"]) == sorted(c["reduced"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            # never a width
            assert not re.search(r"(size|dim|rank|width|heads|expert)",
                                 key), key


def test_workloads():
    assert 1 <= len(WORKLOADS) <= 24 and len(set(WORKLOADS)) == len(WORKLOADS)
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(WORKLOADS)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(WORKLOADS) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert e2e["setup_s"]["bound"] <= 0.25
    assert 1 <= len(METRICS) <= 128
    names = list(e2e) + METRICS
    assert len(set(names)) == len(names)
    layers = {}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        # each listed cell reports the end-to-end metric it moves
        moved = e2e[m["moves"]].get("workloads", WORKLOADS)
        assert set(m["workloads"]) <= set(moved) & set(WORKLOADS)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_found_by_name(name):
    c = spec.cell(name)
    assert c.family.__name__.endswith(c.config["family"])
    assert c.kind.run
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert set(c.check["limits"]) and all(
        v > 0 for v in c.check["limits"].values())


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_found_by_name(name):
    read = spec.reader(name)
    assert callable(read)


def test_every_file_is_named_from_a_name():
    bad = [str(p) for p in spec.HERE.rglob("*") if p.is_file()
           and "__pycache__" not in p.parts
           and not re.match(r"^[A-Za-z0-9_.-]+$", p.name)]
    assert not bad


def test_folders_offer_what_the_benchmark_names():
    assert set(METRICS) <= set(spec.names("metrics"))
    assert set(WORKLOADS) <= set(spec.names("cells"))
    assert {w["traffic"] for w in BENCH["workloads"]} <= set(
        spec.names("mixes"))

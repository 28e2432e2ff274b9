"""What a run reads from the checkout: ``BENCHMARK.json``'s entry for the
workload, its configuration, mix and cell files, and the readers of its
metrics, each found by its name.

* configuration: the ``file`` that ``BENCHMARK.json`` names;
* mix: ``portbench/mixes/<traffic>.json``;
* cell: ``portbench/cells/<workload>.json`` (the limits of its check);
* per-layer metric: ``portbench/metrics/<name>.py``, whose ``read(r)``
  returns the metric's value or None;
* family and kind: ``portbench/systems/<family>.py`` (the configuration's
  ``family``) and ``portbench/kinds/<kind>.py`` (the mix's ``kind``).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    check: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

    @property
    def family(self):
        return importlib.import_module(
            f"portbench.systems.{self.config['family']}")

    @property
    def kind(self):
        return importlib.import_module(f"portbench.kinds.{self.mix['kind']}")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json`` with its files; its
    end-to-end metrics are those whose ``workloads`` list it (or that
    have none: ``setup_s``), its per-layer metrics those whose
    ``workloads`` list it or, without the key, that move one of them."""
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; BENCHMARK.json has "
                       f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / conf["file"])
    config.setdefault("name", conf["name"])
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return Cell(name=name, chips=w["chips"], config=config,
                mix=load_json(HERE / "mixes" / f"{w['traffic']}.json"),
                check=load_json(HERE / "cells" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


def reader(metric: str):
    """``read`` of ``portbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def names(folder: str) -> List[str]:
    """The names a folder of ``portbench`` offers: its files' stems."""
    folder = HERE / folder
    return sorted(p.name[:-len(p.suffix)] for p in folder.iterdir()
                  if p.suffix in (".json", ".py") and p.name != "__init__.py")

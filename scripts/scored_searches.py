#!/usr/bin/env python3
"""Warm general-objective DSE searches of the port on one CUDA card.

    python3 scripts/scored_searches.py [--src DIR] [--out FILE]

From the repository root.  Times every search that ``chip_smoke.py``
scores with an objective other than cycles -- ResNet-50's energy and EDP
searches for inference and training on the Table VIII lattice, the power
cap and the custom numpy objective there, EDP on the 128-step lattice
(phase 3), and the LLM energy and EDP searches (phase 7) -- on its torch
backend alone, each searched once to build its tables and then timed by
``chip_smoke.time_scored`` with the counts phases 6 and 9 use.
``--src`` imports the port from another tree (an unpacked parent commit,
say): run that tree's and this tree's in one call, as parent, this, this,
parent, to compare the two on one card.  About a minute a run.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def smoke_module():
    """``chip_smoke.py`` as a module (its ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree whose repro_torch is timed")
    ap.add_argument("--out", help="also write the rows as JSON here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("scored_searches: no CUDA card", file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        print(f"scored_searches: repro_torch came from "
              f"{repro_torch.__file__}, not {src}", file=sys.stderr)
        return 1
    smoke = smoke_module()
    device = torch.device("cuda")
    card = smoke.card_line()
    rows = {}
    for label, study_kw, wl_kw, obj in (smoke.main_path_searches()
                                        + smoke.llm_searches()):
        if obj == "cycles":
            continue
        smoke.run_search(study_kw, wl_kw, obj, device)   # the tables, once
        counts = smoke.LLM_TIMING if label.startswith("llm/") else {}
        rows[label] = smoke.time_scored(label, study_kw, wl_kw, obj, device,
                                        (study_kw["backend"],), **counts)
        print(f"{label}: " + ", ".join(f"{k} {v}" for k, v in
                                       rows[label].items())
              + f"  [{card}]", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"src": str(src), "card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

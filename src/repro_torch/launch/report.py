"""Render the roofline table from the port's dry-run artifacts
(``launch/dryrun.py``, ``artifacts/dryrun_torch/``): per (arch x shape x
mesh) the three terms, the dominant bound, MODEL_FLOPS ratio, and
per-device memory.  The port's own copy of the JAX package's
``launch/report.py``; a ``None`` term or temp size (a cell the port's
partitioned route does not run) renders ``-``.

  PYTHONPATH=src python -m repro_torch.launch.report [--mesh 16x16]
"""
from __future__ import annotations

import argparse
import json
import pathlib

ART_DIR = (pathlib.Path(__file__).resolve().parents[3] / "artifacts"
           / "dryrun_torch")


def fmt(v, unit=""):
    if v is None:
        return "-"
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) < 1e-2 or abs(v) >= 1e4:
            return f"{v:.2e}{unit}"
        return f"{v:.3f}{unit}"
    return str(v)


def load(mesh: str):
    rows = []
    for p in sorted(ART_DIR.glob(f"*.{mesh}.json")):
        rows.append(json.loads(p.read_text()))
    return rows


def render(mesh: str) -> str:
    rows = load(mesh)
    out = [f"### Mesh {mesh}",
           "",
           "| arch | shape | t_compute (s) | t_memory (s) | t_collective (s)"
           " | bound | roofline frac | 6ND/HLO | temp GB/dev |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"skipped | — | — | — |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"ERROR | — | — | — |")
            continue
        rf = r["roofline"]
        temp = r["memory"]["temp_bytes"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt(rf['t_compute_s'])} | "
            f"{fmt(rf['t_memory_s'])} | {fmt(rf['t_collective_s'])} | "
            f"{rf['bound']} | {rf['roofline_fraction']:.3f} | "
            f"{rf['model_flops_ratio']:.2f} | "
            f"{'-' if temp is None else f'{temp / 1e9:.1f}'} |")
    return "\n".join(out)


def render_improvement(mesh: str = "16x16") -> str:
    """Baseline vs optimized (--optimized sweep) per cell."""
    base = {(r["arch"], r["shape"]): r for r in load(mesh)}
    rows = ["### Baseline vs optimized (winning §Perf variants everywhere)",
            "",
            "| arch | shape | base step (s) | opt step (s) | speedup | "
            "base bound→opt bound | base frac→opt frac |",
            "|---|---|---|---|---|---|---|"]
    for p in sorted(ART_DIR.glob(f"*.{mesh}.opt.json")):
        o = json.loads(p.read_text())
        if o.get("status") != "ok":
            continue
        b = base.get((o["arch"], o["shape"]))
        if not b or b.get("status") != "ok":
            continue
        rb, ro = b["roofline"], o["roofline"]
        sp = rb["step_time_s"] / ro["step_time_s"] if ro["step_time_s"] else 0
        rows.append(
            f"| {o['arch']} | {o['shape']} | {fmt(rb['step_time_s'])} | "
            f"{fmt(ro['step_time_s'])} | {sp:.2f}x | "
            f"{rb['bound']}→{ro['bound']} | "
            f"{rb['roofline_fraction']:.3f}→{ro['roofline_fraction']:.3f} |")
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--improvement", action="store_true")
    args = ap.parse_args()
    if args.improvement:
        print(render_improvement(args.mesh or "16x16"))
        return
    meshes = [args.mesh] if args.mesh else ["16x16", "2x16x16"]
    for m in meshes:
        print(render(m))
        print()


if __name__ == "__main__":
    main()

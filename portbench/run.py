"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell, its configuration, mix, check
limits and metrics are found by name (``portbench/spec.py``).  The run
makes its weights and inputs from ``--seed``, warms up its own shapes,
measures for ``--seconds``, checks what the timed path produced against
the plain reference, and prints as its last line of standard output one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown`` and ``port_launches`` (the
port's own launch counters a step, batch or prefill, by kernel and GEMM
route), ``setup_parts`` (set-up's
seconds by part: ``start``, the interpreter and imports; ``cuda``, the
CUDA context; ``inputs``;
``program``, weights and the program's objects; ``warm-up``, the first
calls, which load the kernels, and a training cell's checked steps), and
last ``checks`` (each compared number beside its limit, printed on
standard error too, after the set-up's parts).

It exits 1 and prints no result without a CUDA card (or with fewer cards
than the cell asks for), when the program fails, or when the process has
loaded JAX or the JAX package.  Caches live in the checkout: the port's
CUDA libraries in ``src/repro_torch/kernels/build/``, and any Triton or
extension cache under ``.portbench_cache/``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Paths and caches, before PyTorch is imported."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / ".portbench_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    # the script's own folder is not a package root: its modules' names
    # (trace, check, ...) would shadow others'
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p != here]
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    for path in (str(ROOT / "src"), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)


def loaded_forbidden() -> list:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             started=None) -> dict:
    """Run ``cell`` once on ``device`` and return the result's fields
    (without ``device``'s card fields); ``started``: the set-up clock's
    origin (``time.perf_counter`` scale)."""
    import torch
    from portbench import context, spec
    from repro_torch.kernels import ops
    from portbench.record import RecordingOps
    recorder = RecordingOps(ops) if trace else None
    kw = {} if started is None else {"started": started}
    ctx = context.Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                          device=torch.device(device),
                          impl=recorder or ops, recorder=recorder, **kw)
    ctx.mark("start", sync=False)
    ctx.mark("cuda")
    out = cell.kind.run(ctx)
    from portbench import check
    limits = cell.check["limits"]
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in out["numbers"].items()}
    result = {"correct": check.held(out["numbers"], limits),
              "attempted": out["attempted"], "failed": out["failed"]}
    if trace:
        r = out["reading"]
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"])(r)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        result["trace"] = {"busy_s": r["busy_s"], "window_s": r["window_s"]}
        result["port_launches"] = {k: n / r["units"] for k, n in
                                   r["port_launches"].items() if n}
        result["breakdown"] = {"device_ops": [list(x) for x in
                                              r["device_ops"]],
                               "idle_gaps": [list(x) for x in
                                             r["idle_gaps"]]}
    else:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["memory_peak_bytes"] = out["memory_peak_bytes"]
    result["setup_parts"] = ctx.parts
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    from portbench import context, spec
    started = time.perf_counter() - context.process_age()
    cell = spec.cell(args.workload)
    import torch
    torch.set_num_threads(2)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", started=started)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 1
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": result.pop("memory_peak_bytes")}
    device.update(result.pop("trace", {}))
    checks = result.pop("checks")
    line = dict(result, device=device, checks=checks)
    for name, n in line.get("port_launches", {}).items():
        print(f"launches {name} {n!r} a unit", file=sys.stderr)
    for part, seconds in line["setup_parts"].items():
        print(f"setup {part} {seconds!r} s", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out FILE]

From the repository root, on a machine with one CUDA card:

1. prints the card, its power limit and the software versions;
2. builds the CUDA kernel ``grid_minmax.cu`` from this checkout's sources;
3. drives the main path — ``Study(hw).search(Workload("resnet50"[,
   training=True]), 2048, 2048, objective=...)`` at the 64x64 presets on
   the Table VIII power-of-two lattice (cycles through the fused kernel,
   energy and EDP through the torch reductions), the same searches
   for cycles on the 128-step lattice (5.5M candidates), and
   ``search_many`` over every CNN of the registry — with the kernel's
   launch count set to 0 before each path and read after it;
4. holds every result bit-identical to the port's numpy engine (best,
   worst, frontiers, Pareto set, cost and score grids) and the training
   grids past 2**31;
5. holds ``grid_minmax`` exactly equal to ``grid_minmax_ref`` on the card
   on seeded random, tie, extreme and degenerate grids and on the inputs
   the main path gave it;
6. times the kernel, its plain version and the warm searches with CUDA
   events, beside the bound of the kernel on this card.

Any failed phase raises and the script exits non-zero.  Without CUDA, or
without the repository's ``src/`` beside it, it exits non-zero and prints
no result.  The last line is ``{"ok": true, "device": {...}}``; the line
before it lists the kernels as JSON.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3
# bandwidth, and the scalar (non-tensor-core) float32 rate, the table's
# only rate for CUDA-core arithmetic; int64 adds and compares run there.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

LATTICE_128 = tuple(range(128, 2049, 128))
BUDGET_KB = 2048
BUDGET_BW = 2048


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream, by CUDA
    events around ``iters`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def main_path_searches(device):
    """``(label, study_kwargs, workload_kwargs, objective)`` of every
    search on the main path."""
    from repro_torch.core import INFER_PRESETS, TRAIN_PRESETS
    out = []
    for phase, presets in (("inference", INFER_PRESETS),
                           ("training", TRAIN_PRESETS)):
        hw = presets[64]
        wl = dict(net="resnet50", training=phase == "training")
        out.append((f"table8/{phase}/cycles",
                    dict(hw=hw, backend="torch-fused"), wl, "cycles"))
        for obj in ("energy", "edp"):
            out.append((f"table8/{phase}/{obj}",
                        dict(hw=hw, backend="torch"), wl, obj))
    for phase, presets in (("inference", INFER_PRESETS),
                           ("training", TRAIN_PRESETS)):
        out.append((f"lattice128/{phase}/cycles",
                    dict(hw=presets[64], backend="torch-fused",
                         sizes=LATTICE_128, bws=LATTICE_128),
                    dict(net="resnet50", training=phase == "training"),
                    "cycles"))
    return out


def run_search(study_kw, wl_kw, objective, device, backend=None):
    from repro_torch.core import Study, Workload
    kw = dict(study_kw)
    hw = kw.pop("hw")
    if backend is not None:
        kw["backend"] = backend
    return Study(hw, device=device, **kw).search(
        Workload(**wl_kw), BUDGET_KB, BUDGET_BW, objective=objective)


def run_search_many(device, backend):
    from repro_torch.core import INFER_PRESETS, Study
    from repro_torch.core.networks import NETWORKS
    return Study(INFER_PRESETS[64], backend=backend, device=device) \
        .search_many({n: n for n in NETWORKS}, BUDGET_KB, BUDGET_BW)


class Recorder:
    """Wraps ``gridtorch.grid_minmax`` to keep, per path, the inputs the
    main path gives the kernel, and ``reduce.grid_minmax_ref`` to count
    calls of the plain version (none may come from the main path on the
    card)."""

    def __init__(self):
        from repro_torch.core import gridtorch
        from repro_torch.kernels import reduce
        self.gridtorch, self.reduce = gridtorch, reduce
        self.kernel, self.ref = gridtorch.grid_minmax, reduce.grid_minmax_ref
        self.label = None
        self.inputs = {}
        self.ref_calls = 0

    def __enter__(self):
        def kernel(*args):
            self.inputs.setdefault(self.label, args)
            return self.kernel(*args)

        def ref(*args):
            self.ref_calls += 1
            return self.ref(*args)
        self.gridtorch.grid_minmax = kernel
        self.reduce.grid_minmax_ref = ref
        return self

    def __exit__(self, *exc):
        self.gridtorch.grid_minmax = self.kernel
        self.reduce.grid_minmax_ref = self.ref


def drive_main_path(device):
    """Run every main-path search once.  Returns the results, per path the
    launches of ``grid_minmax`` (set to 0 just before the path, read just
    after), the wall seconds, and the first kernel inputs of each path."""
    from repro_torch.kernels.reduce import grid_minmax
    paths = [(label, lambda s=s, w=w, o=o: run_search(s, w, o, device))
             for label, s, w, o in main_path_searches(device)]
    paths.append(("search_many/torch",
                  lambda: run_search_many(device, "torch")))
    results, launches, wall_s = {}, {}, {}
    with Recorder() as rec:
        for label, fn in paths:
            rec.label = label
            grid_minmax.launches = 0
            t0 = time.perf_counter()
            results[label] = fn()
            wall_s[label] = time.perf_counter() - t0
            launches[label] = grid_minmax.launches
    if device.type == "cuda":
        check(rec.ref_calls == 0, f"plain grid_minmax_ref ran "
              f"{rec.ref_calls} times on the main path on the card")
    return results, launches, wall_s, rec.inputs


# ---------------------------------------------------------------------------
# parity with the numpy engine
# ---------------------------------------------------------------------------

def _pt(p):
    return (p.sizes_kb, p.bws, p.cycles)


def compare(label, got, want) -> int:
    """Hold one result bit-identical to the numpy engine's; returns the
    number of checks made."""
    checks = [
        ("best", _pt(got.best), _pt(want.best)),
        ("worst", _pt(got.worst), _pt(want.worst)),
        ("improvement", got.improvement, want.improvement),
        ("frontier", [_pt(p) for p in got.points],
         [_pt(p) for p in want.points]),
        ("within 5%", [_pt(p) for p in got.within(0.05)],
         [_pt(p) for p in want.within(0.05)]),
        ("pareto", [_pt(p) for p in got.pareto()],
         [_pt(p) for p in want.pareto()]),
        ("size tuples", got.grid.size_tuples, want.grid.size_tuples),
        ("bw tuples", got.grid.bw_tuples, want.grid.bw_tuples),
    ]
    for what, a, b in checks:
        check(a == b, f"{label}: {what} differs from the numpy engine")
    check(got.grid.costs.dtype == np.int64, f"{label}: costs not int64")
    check(np.array_equal(got.grid.costs, want.grid.costs),
          f"{label}: cost grid differs from the numpy engine")
    if want.grid_scores is None:
        check(got.grid_scores is None, f"{label}: unexpected score grid")
    else:
        check(got.grid_scores.dtype == np.float64
              and np.array_equal(got.grid_scores, want.grid_scores),
              f"{label}: score grid differs from the numpy engine")
    return len(checks) + 2


def hold_against_numpy(results, device) -> dict:
    n_checks = 0
    for label, study_kw, wl_kw, obj in main_path_searches(device):
        want = run_search(study_kw, wl_kw, obj, device, backend="numpy")
        n_checks += compare(label, results[label], want)
    many = run_search_many(device, "numpy")
    for name, want in many.items():
        n_checks += compare(f"search_many/{name}",
                            results["search_many/torch"][name], want)
    grid_max = {label: int(results[label].grid.costs.max())
                for label in results if "training/cycles" in label}
    for label, m in grid_max.items():
        check(m > 2 ** 31, f"{label}: training grid max {m} not past 2**31")
    return {"checks": n_checks, "training_grid_max": grid_max}


# ---------------------------------------------------------------------------
# the kernel against its plain version
# ---------------------------------------------------------------------------

def _case(rng, n_conv, n_simd, n_rows, nb, lo=2 ** 31, hi=2 ** 34):
    return (rng.integers(lo, hi, size=(n_conv, nb), dtype=np.int64),
            rng.integers(lo, hi, size=(n_simd, nb), dtype=np.int64),
            rng.integers(0, n_conv, size=n_rows, dtype=np.int64),
            rng.integers(0, n_simd, size=n_rows, dtype=np.int64))


def _placed_ties(n_rows, nb):
    """Two equal minima and two equal maxima in far-apart blocks, the
    later one at the smaller column: first occurrence must win."""
    conv = np.full((n_rows, nb), 5 * 2 ** 32, dtype=np.int64)
    conv[n_rows * 3 // 4, 3] = conv[n_rows // 10, nb - 5] = 2 ** 32
    conv[n_rows - 1, 0] = conv[n_rows // 3, nb - 1] = 9 * 2 ** 32
    return (conv, np.zeros((1, nb), np.int64),
            np.arange(n_rows, dtype=np.int64),
            np.zeros(n_rows, dtype=np.int64))


def kernel_cases():
    rng = np.random.default_rng(2026)
    i64 = np.iinfo(np.int64)
    cases = {
        "random_past_2_31": _case(rng, 40, 7, 600, 311),
        "ties_few_values": _case(rng, 50, 3, 1500, 97, lo=2 ** 33,
                                 hi=2 ** 33 + 4),
        "ties_placed": _placed_ties(3000, 300),
        "1x1": _case(rng, 1, 1, 1, 1),
        "1xN": _case(rng, 1, 2, 1, 100_003),
        "Nx1": _case(rng, 1000, 3, 100_003, 1),
        "rows_not_multiple_of_tile": _case(rng, 97, 5, 1061, 129),
        "all_int64_max": (np.full((2, 33), i64.max, np.int64),
                          np.zeros((1, 33), np.int64),
                          np.array([1, 0, 1], np.int64),
                          np.zeros(3, np.int64)),
        "all_int64_min": (np.full((2, 33), i64.min, np.int64),
                          np.zeros((1, 33), np.int64),
                          np.array([0, 1, 1], np.int64),
                          np.zeros(3, np.int64)),
        "table8_shape_311x311": _case(rng, 150, 11, 311, 311),
        "lattice128_shape_2345x2345": _case(rng, 680, 16, 2345, 2345),
    }
    return cases


def hold_kernel(cases_dev) -> dict:
    """Exact equality of the kernel and its plain version on the card;
    launches made here are not the main path's and are not counted."""
    from repro_torch.kernels.reduce import grid_minmax, grid_minmax_ref
    max_err, out = 0, {}
    for name, args in cases_dev.items():
        k = grid_minmax(*args)
        r = grid_minmax_ref(*args)
        torch.cuda.synchronize()
        err = int((k - r).abs().max()) if not torch.equal(k, r) else 0
        max_err = max(max_err, err)
        out[name] = {"shape": [int(args[2].shape[0]), int(args[0].shape[1])],
                     "kernel": k.tolist(), "ref": r.tolist()}
        check(torch.equal(k, r), f"grid_minmax != grid_minmax_ref on "
              f"{name}: {k.tolist()} vs {r.tolist()}")
    return {"cases": out, "max_abs_err": max_err}


def kernel_bound_ms(args) -> tuple:
    """Least time the card needs for one call: each input read once and
    the 32-byte result written once, over HBM bandwidth, against three
    int64 operations per candidate (add, two compares) over the scalar
    rate.  Returns ``(bound_ms, bound_by, gathered_bytes_ms)``; the last
    counts the gathered operand rows (16 bytes per candidate) instead."""
    conv, simd, s3_of, v_of = args
    n = int(s3_of.shape[0]) * int(conv.shape[1])
    nbytes = sum(t.numel() * t.element_size() for t in args) + 32
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * n / SCALAR_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", 16 * n / HBM_BYTES_PER_S * 1e3)


def profile_device_ms(fn, iters: int, match: str = "") -> dict:
    """Device time of ``iters`` calls of ``fn`` from the profiler's trace:
    milliseconds per call in kernels and copies whose name contains
    ``match`` (all of them if empty), and the wall milliseconds per call
    around them.  ``None`` where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us = 0.0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or match not in evt.name:
            continue
        device_us += evt.device_time_total
    return {"device_ms": device_us / iters / 1e3 if device_us else None,
            "wall_ms": wall / iters * 1e3}


def time_kernel(args) -> dict:
    from repro_torch.kernels.reduce import grid_minmax, grid_minmax_ref
    bound, bound_by, gathered = kernel_bound_ms(args)
    prof = profile_device_ms(lambda: grid_minmax(*args), iters=50,
                             match="grid_minmax")
    return {"shape": [int(args[2].shape[0]), int(args[0].shape[1])],
            "ms": cuda_ms(lambda: grid_minmax(*args), iters=200, warmup=20),
            "device_ms": prof["device_ms"],
            "plain_ms": cuda_ms(lambda: grid_minmax_ref(*args), iters=50,
                                warmup=5),
            "bound_ms": bound, "bound_by": bound_by,
            "gathered_bytes_bound_ms": gathered}


def _search_and_read(study_kw, wl_kw, obj, device, backend):
    """What a user of a search pays: the search, then its frontier and
    its Pareto set."""
    res = run_search(study_kw, wl_kw, obj, device, backend=backend)
    return len(res.points), len(res.pareto())


def time_searches(device) -> dict:
    """Warm searches (tables cached by the first drive), per main-path
    search: the torch backend it runs on against the numpy engine, for the
    search call alone and for the search followed by reading its frontier
    and Pareto set; CUDA events around each call (the search ends in host
    copies, so the events bracket all of its device work).  For the torch
    backend, also the device's busy time in one read search from the
    profiler, and so its idle share."""
    out = {}
    for label, study_kw, wl_kw, obj in main_path_searches(device):
        row = {}
        iters = 1 if label.startswith("lattice128") else 3
        for backend in (study_kw["backend"], "numpy"):
            row[f"{backend} search_ms"] = cuda_ms(
                lambda b=backend: run_search(study_kw, wl_kw, obj, device,
                                             backend=b),
                iters=iters, warmup=1)
            row[f"{backend} search+read_ms"] = cuda_ms(
                lambda b=backend: _search_and_read(study_kw, wl_kw, obj,
                                                   device, b),
                iters=iters, warmup=0)
        prof = profile_device_ms(lambda: _search_and_read(
            study_kw, wl_kw, obj, device, study_kw["backend"]), iters=1)
        row["device_busy_ms"] = prof["device_ms"]
        row["idle_share"] = None if prof["device_ms"] is None \
            else 1.0 - prof["device_ms"] / prof["wall_ms"]
        out[label] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _ext, reduce

    device = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    report = {"card": card, "kind": kind, "torch": torch.__version__,
              "cuda": torch.version.cuda, "python": sys.version.split()[0]}
    print(f"card: {card}")
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {report['python']}")

    t0 = time.perf_counter()
    reduce._library()
    report["build_s"] = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _ext.BUILD_LOGS.get(reduce.SOURCE, "")
             .splitlines() if "registers" in ln or "spill" in ln]
    report["ptxas"] = ptxas
    print(f"build: {reduce.SOURCE} in {report['build_s']} s -> "
          f"{_ext.library_path(reduce.SOURCE).relative_to(ROOT)}")
    for ln in ptxas:
        print(f"  ptxas: {ln}")

    results, launches, wall_s, inputs = drive_main_path(device)
    report["launches"] = launches
    report["first_search_s"] = wall_s
    print(f"main path launches of grid_minmax: {launches}")
    for label, s in wall_s.items():
        print(f"  first search {label}: {s} s")
    fused = [lab for lab, _, _, _ in main_path_searches(device)
             if lab.endswith("/cycles")]
    for label in fused:
        check(launches[label] >= 1,
              f"{label}: the main path never launched grid_minmax")

    report["parity"] = hold_against_numpy(results, device)
    print(f"parity with the numpy engine: {report['parity']['checks']} "
          f"checks passed; training grid max "
          f"{report['parity']['training_grid_max']}")

    cases = {name: tuple(torch.from_numpy(a).to(device) for a in arrs)
             for name, arrs in kernel_cases().items()}
    for label, args_ in inputs.items():
        cases[f"main_path/{label}"] = args_
    held = hold_kernel(cases)
    report["kernel_checks"] = held
    print(f"grid_minmax == grid_minmax_ref exactly on {len(cases)} cases "
          f"({', '.join(cases)})")

    timing = {label: time_kernel(args_) for label, args_ in inputs.items()}
    report["kernel_times"] = timing
    for label, t in timing.items():
        print(f"  grid_minmax {label} {t['shape']}: {t['ms']} ms "
              f"(device {t['device_ms']} ms), plain "
              f"{t['plain_ms']} ms, bound {t['bound_ms']} ms "
              f"({t['bound_by']}), gathered-bytes bound "
              f"{t['gathered_bytes_bound_ms']} ms  [{card}]")
    report["search_ms"] = time_searches(device)
    for label, row in report["search_ms"].items():
        print(f"  warm search {label}: " + ", ".join(
            f"{k} {v}" for k, v in row.items()) + f"  [{card}]")

    main_label = "lattice128/training/cycles"
    t = timing[main_label]
    kernels = {"kernels": [{
        "name": "grid_minmax", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/grid_minmax.cu",
        "replaces": "src/repro/kernels/reduce.py:65",
        "launches": sum(launches.values()),
        "checks": len(cases),
        "max_abs_err": held["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "device_ms": t["device_ms"],
        "shape": t["shape"], "timed_on": main_label,
    }]}
    report.update(kernels)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1, default=str))
    print(card_line())
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

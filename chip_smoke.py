#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out FILE]

From the repository root, on a machine with one CUDA card:

1. prints the card, its power limit and the software versions;
2. builds every CUDA kernel of the port from this checkout's sources
   (``src/repro_torch/kernels/csrc/*.cu``), one ``nvcc`` each, all at once;
3. drives the DSE main path -- ``Study(hw).search(Workload("resnet50"[,
   training=True]), 2048, 2048, objective=...)`` at the 64x64 presets on
   the Table VIII power-of-two lattice (cycles through the fused kernel,
   energy and EDP through the torch reductions), the same searches
   for cycles on the 128-step lattice (5.5M candidates), and
   ``search_many`` over every CNN of the registry -- with the
   ``grid_minmax`` launch count set to 0 before each path and read after;
4. holds every result bit-identical to the port's numpy engine (best,
   worst, frontiers, Pareto set, cost and score grids) and the training
   grids past 2**31;
5. holds ``grid_minmax`` exactly equal to ``grid_minmax_ref`` on the card
   on seeded random, tie, extreme and degenerate grids and on the inputs
   the main path gave it;
6. times the kernel, its plain version and the warm searches with CUDA
   events (the kernel also on the device alone, queued behind a device
   sleep, and from the profiler's trace), beside its bound on this card;
7. drives the kernel entry points ``repro_torch.kernels.ops`` at the full
   width of two models, every launch counter set to 0 before each model
   and read after it: a Qwen3-0.6B prefill of 2 x 2048 tokens in bf16
   (all 28 layers; GEMMs, fused add+RMSNorm, causal GQA flash attention,
   the tied LM head) and ResNet-50 at batch 32 (its 53 BN layers in
   float32, its 54 convolutions as bf16 GEMMs);
8. holds each of the four kernels against its plain version on the card,
   on the inputs the models gave it and on the edge cases of
   ``tests/test_kernels.py``, with that file's tolerances (the main
   path's bf16 attention also by the relative error of each query row,
   and float32 attention at its shape), and the whole decoder against
   the same composition of plain versions;
9. times each kernel at those shapes beside its plain version, the one
   PyTorch call that computes the same (where there is one) and its bound:
   through the wrapper (CUDA events), on the device alone (the calls
   queued behind a device sleep), and as the profiler's trace sees it;
   and times every compiled GEMM tile against the tile model's pick.

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
    ``match`` (all of them if empty), the wall milliseconds per call
    around them, and the kernel records found.  ``None`` where the trace
    holds no device time.  The trace on the H100 drops some kernel
    records, so the time reads low where ``records`` falls short of the
    launches."""
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
    device_us, records = 0.0, 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or match not in evt.name:
            continue
        device_us += evt.device_time_total
        records += 1
    return {"device_ms": device_us / iters / 1e3 if device_us else None,
            "wall_ms": wall / iters * 1e3, "records": records}


def time_kernel(args) -> dict:
    from repro_torch.kernels.reduce import grid_minmax, grid_minmax_ref
    bound, bound_by, gathered = kernel_bound_ms(args)
    prof = profile_device_ms(lambda: grid_minmax(*args), iters=50,
                             match="grid_minmax")
    return {"shape": [int(args[2].shape[0]), int(args[0].shape[1])],
            "ms": cuda_ms(lambda: grid_minmax(*args), iters=200, warmup=20),
            "device_ms": queued_ms(lambda: grid_minmax(*args), iters=200,
                                   warmup=20),
            "profiler_ms": prof["device_ms"],
            # two kernels a call: per-block partials, then the final merge
            "profiler_records": f"{prof['records']} of 100",
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


# ---------------------------------------------------------------------------
# the kernel slice: repro_torch.kernels.ops at Qwen3-0.6B and ResNet-50 widths
# ---------------------------------------------------------------------------

# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet, 700 W)
BF16_OPS_PER_S = 989e12
SLICE_SEED = 2026
QWEN_BATCH, QWEN_SEQ = 2, 2048          # one prefill of 4096 tokens
RESNET_BATCH = 32
OPS = ("matmul", "fused_add_rmsnorm", "flash_attention", "bn_forward")
# The tolerances of tests/test_kernels.py, (atol, rtol):
TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (3e-2, 3e-2)}
ATTN_F32_TOL = (2e-5, 2e-5)
# fused add+norm and BN compare with numpy's assert_allclose default rtol
ADDNORM_F32_TOL = {"y": (1e-5, 1e-7), "res": (1e-6, 1e-7)}
BN_F32_TOL = {"y": (1e-4, 1e-7), "mu": (1e-5, 1e-7), "psi": (1e-4, 1e-7)}
# The whole bf16 decoder against the same composition of plain versions:
# relative Frobenius error of the logits, the bf16 tolerance of the tests
# applied to the norm (the plain attention rounds its logits to bf16 and
# the kernel does not, so elementwise bounds do not carry through layers).
SLICE_BF16_REL = 3e-2
# The main path's bf16 attention, per query row: |got - want| / |want| over
# the row's head_dim.  Late causal queries average ~2048 keys, so their
# outputs are ~0.04 and an elementwise atol of 3e-2 cannot see a lost key
# tile; a row norm can.  On the CPU (seeded N(0,1) q, k, v at S 2048, D
# 128) bf16 against float32 reads 0.0101 at the worst row, and dropping
# one 64-key tile for the later queries 0.77.  The limit is the bf16
# tolerance of the tests applied to the row norm.
ATTN_BF16_ROW_REL = 3e-2

KERNEL_META = {
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
               "src/repro/kernels/matmul.py:30"),
    "fused_add_rmsnorm": ("src/repro_torch/kernels/csrc/fused_addnorm.cu",
                          "src/repro/kernels/fused_addnorm.py:27"),
    "bn_forward": ("src/repro_torch/kernels/csrc/bn_forward.cu",
                   "src/repro/kernels/bn.py:50"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:66"),
}


def _counters():
    from repro_torch.kernels import ops
    return ops.launch_counters()


class RecordingOps:
    """The ``impl`` a model forward is driven with: every call goes on to
    ``kernels.ops``, and the inputs of the first call of each kernel at
    each shape are kept, by ``(kernel, shapes)``, with the model that made
    it."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.model = None
        self.inputs = {}
        for name in OPS:
            setattr(self, name, self._recorded(name, getattr(ops, name)))

    def _recorded(self, name, fn):
        def call(*args, **kwargs):
            key = (name, tuple(tuple(a.shape) for a in args
                               if isinstance(a, torch.Tensor)))
            self.inputs.setdefault(key, (self.model, args, kwargs))
            return fn(*args, **kwargs)
        return call


def qwen_inputs(device):
    from repro_torch.kernels import forward as F
    dims = F.QWEN3_0_6B
    params = F.init_decoder_params(dims, dims.n_layers, SLICE_SEED, device)
    gen = torch.Generator(device=device).manual_seed(SLICE_SEED + 1)
    ids = torch.randint(0, dims.vocab, (QWEN_BATCH, QWEN_SEQ),
                        generator=gen, device=device)
    return dims, params, ids


def resnet_inputs(device):
    """Per distinct shape of ResNet-50's kernel calls, seeded inputs: x
    (N_eff, C) float32 with gamma, beta for BN; A (M, K) and B (K, N)
    bfloat16, B scaled by 1/sqrt(K), for a GEMM."""
    from repro_torch.kernels import forward as F
    calls = F.resnet50_calls(RESNET_BATCH)
    gen = torch.Generator(device=device).manual_seed(SLICE_SEED + 2)

    def rn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=device) * std
    inputs = {}
    for kind, _, shape in calls:
        if shape in inputs:
            continue
        if kind == "bn_forward":
            n, c = shape
            inputs[shape] = (rn(n, c), rn(c), rn(c))
        else:
            m, k, n = shape
            inputs[shape] = (rn(m, k).to(torch.bfloat16),
                             rn(k, n, std=k ** -0.5).to(torch.bfloat16))
    return calls, inputs


def drive_slice(device):
    """Drive the two models through ``ops`` once each, every launch
    counter set to 0 just before a model and read just after.  Returns
    the outputs, the launches per model, the recorded kernel inputs and
    the wall seconds."""
    from repro_torch.kernels import forward as F
    dims, params, ids = qwen_inputs(device)
    calls, rinputs = resnet_inputs(device)
    rec = RecordingOps()
    runs = {"qwen3_0_6b": lambda: F.decoder_forward(
                ids, params, dims, dims.n_layers, impl=rec),
            "resnet50": lambda: F.resnet50_forward(calls, rinputs, impl=rec)}
    outs, launches, wall = {}, {}, {}
    for model, fn in runs.items():
        rec.model = model
        for counter in _counters().values():
            counter.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[model] = fn()
        torch.cuda.synchronize()
        wall[model] = time.perf_counter() - t0
        launches[model] = {name: c.launches
                           for name, c in _counters().items()}
    want = {"qwen3_0_6b": F.decoder_launches(dims),
            "resnet50": {"bn_forward": 53, "matmul": 54}}
    for model, per in launches.items():
        for name, n in per.items():
            check(n == want[model].get(name, 0),
                  f"{model}: {name} launched {n} times, expected "
                  f"{want[model].get(name, 0)}")
    return {"outs": outs, "launches": launches, "per_forward": want,
            "wall_s": wall, "inputs": rec.inputs,
            "qwen": (dims, params, ids), "resnet": (calls, rinputs)}


def close(got, want, atol, rtol, rows=512):
    """``(max |got - want|, max of |got - want| - atol - rtol |want|)``
    in float32, row block by row block; the second is <= 0 when
    ``got`` is within tolerance everywhere."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"shape/type {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    err, excess = 0.0, float("-inf")
    if got.numel() == 0:
        return err, excess
    g2 = got.reshape(got.shape[0], -1)
    w2 = want.reshape(g2.shape)
    for i in range(0, g2.shape[0], rows):
        g, w = g2[i:i + rows].float(), w2[i:i + rows].float()
        d = (g - w).abs()
        check(bool(torch.isfinite(g).all()), "non-finite kernel output")
        err = max(err, float(d.max()))
        excess = max(excess, float((d - atol - rtol * w.abs()).max()))
    return err, excess


class Held:
    """Kernel-versus-plain checks of one run, per kernel."""

    def __init__(self):
        self.cases = {name: [] for name in OPS}
        self.row_rel = {}        # label -> worst and whole relative error

    def add(self, name, label, pairs):
        """``pairs``: (output name, got, want, (atol, rtol))."""
        worst = 0.0
        for what, got, want, (atol, rtol) in pairs:
            err, excess = close(got, want, atol, rtol)
            worst = max(worst, err)
            check(excess <= 0, f"{name} {label} {what}: max abs err {err} "
                  f"outside atol {atol}, rtol {rtol}")
        self.cases[name].append((label, worst))

    def max_err(self, name):
        return max((e for _, e in self.cases[name]), default=0.0)


def hold_call(held, name, label, args, kwargs, main=False):
    """One kernel call against its plain version on the same inputs;
    ``main``: the inputs came from a model forward."""
    from repro_torch.kernels import ops, ref
    if name == "matmul":
        got = ops.matmul(*args, **kwargs)
        want = ref.matmul_ref(*args[:2])
        held.add(name, label, [("c", got, want, TOL[args[0].dtype])])
    elif name == "flash_attention":
        q, k, v, h, kv = args[:5]
        causal = kwargs.get("causal", args[5] if len(args) > 5 else True)
        window = kwargs.get("window", args[6] if len(args) > 6 else 0)
        got = ops.flash_attention(*args, **kwargs)
        want = ref.flash_attention_ref(q, k, v, h, kv, causal, window)
        tol = ATTN_F32_TOL if q.dtype == torch.float32 else TOL[q.dtype]
        held.add(name, label, [("out", got, want, tol)])
        if main and q.dtype == torch.bfloat16:
            g, w = got.float(), want.float()
            rows = float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())
            held.row_rel[label] = {"worst_row": rows, "whole": float(
                (g - w).norm() / w.norm())}
            check(rows <= ATTN_BF16_ROW_REL, f"{name} {label}: a query row "
                  f"off its plain version by {rows} (relative), above "
                  f"{ATTN_BF16_ROW_REL}")
    elif name == "fused_add_rmsnorm":
        y, res = ops.fused_add_rmsnorm(*args, **kwargs)
        yr, resr = ref.fused_add_rmsnorm_ref(*args[:3])
        if args[0].dtype == torch.float32:
            tols = ADDNORM_F32_TOL
        else:   # res: the float32 sum rounded once in both, so bit-equal
            tols = {"y": TOL[args[0].dtype], "res": (0.0, 0.0)}
        held.add(name, label, [("y", y, yr, tols["y"]),
                               ("res", res, resr, tols["res"])])
    else:
        y, mu, psi = ops.bn_forward(*args, **kwargs)
        yr, mur, psir = ref.bn_forward_ref(*args[:3])
        tols = BN_F32_TOL if args[0].dtype == torch.float32 else {
            "y": TOL[args[0].dtype], "mu": BN_F32_TOL["mu"],
            "psi": BN_F32_TOL["psi"]}
        held.add(name, label, [("y", y, yr, tols["y"]),
                               ("mu", mu, mur, tols["mu"]),
                               ("psi", psi, psir, tols["psi"])])
    torch.cuda.synchronize()


def edge_cases(device):
    """``(name, label, args, kwargs)``: the cases of tests/test_kernels.py
    (zero dims, ragged m/n/k, GQA groups 1, 2 and 8, window 16 causal and
    not, bf16), a ragged non-causal S and bf16 forms of each kernel."""
    gen = torch.Generator(device=device).manual_seed(SLICE_SEED + 3)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for m, n, k in ((64, 64, 64), (200, 90, 130), (128, 256, 512),
                        (33, 17, 65), (1, 128, 7)):
            for tile in ((64, 64, 64), (32, 64, 128), (128, 64, 32), None):
                kw = {} if tile is None else dict(zip(("bm", "bn", "bk"),
                                                      tile))
                out.append(("matmul", f"{dtype} {(m, n, k)} {tile}",
                            (rn(m, k, dtype=dtype), rn(k, n, dtype=dtype)),
                            kw))
    for m, n, k in ((0, 8, 8), (8, 0, 8), (8, 8, 0), (0, 0, 0), (1, 1, 0)):
        for kw in ({}, dict(bm=64, bn=64, bk=64)):
            out.append(("matmul", f"zero dim {(m, n, k)} {kw}",
                        (torch.zeros((m, k), device=device),
                         torch.zeros((k, n), device=device)), kw))
    for heads, kv in ((4, 4), (4, 2), (8, 1)):
        for causal, window in ((True, 0), (True, 16), (False, 0),
                               (False, 16)):
            for s in (64, 96, 40):
                b, d = 2, 16
                out.append(("flash_attention",
                            f"h{heads} kv{kv} causal={causal} w{window} S{s}",
                            (rn(b * heads, s, d), rn(b * kv, s, d),
                             rn(b * kv, s, d), heads, kv),
                            dict(causal=causal, window=window, bq=32, bk=32)))
    for dtype in (torch.float32, torch.bfloat16):
        for d in (16, 32, 64, 128):
            out.append(("flash_attention", f"{dtype} D{d} S300 GQA2",
                        (rn(4, 300, d, dtype=dtype), rn(2, 300, d, dtype=dtype),
                         rn(2, 300, d, dtype=dtype), 2, 1),
                        dict(causal=d != 64)))
    # the main path's attention shape in float32 (B 2, 16 heads, 8 KV)
    out.append(("flash_attention", "float32 (32, 2048, 128) causal GQA2",
                (rn(32, 2048, 128), rn(16, 2048, 128), rn(16, 2048, 128),
                 16, 8), {}))
    for dtype in (torch.float32, torch.bfloat16):
        for rows, d in ((100, 64), (256, 128), (7, 96)):
            out.append(("fused_add_rmsnorm", f"{dtype} {(rows, d)}",
                        (rn(rows, d, dtype=dtype), rn(rows, d, dtype=dtype),
                         rn(d)), dict(block_rows=64)))
    for dtype in (torch.float32, torch.bfloat16):
        for n, c in ((300, 70), (256, 128), (64, 33)):
            out.append(("bn_forward", f"{dtype} {(n, c)}",
                        (rn(n, c, dtype=dtype), rn(c), rn(c)),
                        dict(block_rows=64, block_c=32)))
    # a shifted mean (+10): the one-pass variance still within tolerance
    out.append(("bn_forward", "shift 10 (4096, 64)",
                (rn(4096, 64) + 10.0, rn(64), rn(64)), {}))
    return out


def hold_slice(slice_run, device) -> Held:
    """Every kernel against its plain version on the card: on the inputs
    the main path gave it (one per shape), on the edge cases, and the
    whole bf16 decoder against the composition of the plain versions; a
    float32 decoder cut to small widths is held elementwise."""
    from repro_torch.kernels import forward as F
    held = Held()
    for (name, shapes), (model, args, kwargs) in \
            slice_run["inputs"].items():
        hold_call(held, name, f"main path {model} {shapes}", args, kwargs,
                  main=True)
    for name, label, args, kwargs in edge_cases(device):
        hold_call(held, name, label, args, kwargs)

    dims, params, ids = slice_run["qwen"]
    got = slice_run["outs"]["qwen3_0_6b"]
    check(got.shape == (QWEN_BATCH * QWEN_SEQ, dims.vocab)
          and bool(torch.isfinite(got).all()),
          f"decoder logits {tuple(got.shape)} not finite or misshapen")
    want = F.decoder_forward(ids, params, dims, dims.n_layers, impl=F.PLAIN)
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    check(rel <= SLICE_BF16_REL, f"bf16 decoder logits off the plain "
          f"composition by {rel} (relative), above {SLICE_BF16_REL}")
    small = F.DecoderDims(d_model=128, n_heads=4, n_kv=2, head_dim=32,
                          d_ff=256, vocab=512, n_layers=2)
    sp = F.init_decoder_params(small, 2, SLICE_SEED, device, torch.float32)
    sids = torch.randint(0, small.vocab, (2, 96), device=device,
                         generator=torch.Generator(device=device)
                         .manual_seed(SLICE_SEED))
    err, excess = close(F.decoder_forward(sids, sp, small, 2),
                        F.decoder_forward(sids, sp, small, 2,
                                          impl=F.PLAIN), *TOL[torch.float32])
    check(excess <= 0, f"f32 small decoder off its plain composition by "
          f"{err}")
    for out in slice_run["outs"]["resnet50"]:
        tensors = out if isinstance(out, tuple) else (out,)
        check(all(bool(torch.isfinite(t).all()) for t in tensors),
              "ResNet-50 slice output not finite")
    return {"held": held, "decoder_bf16_rel_err": rel,
            "decoder_f32_small_max_err": err}


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops, nbytes, peak):
    """Least milliseconds for ``flops`` at ``peak`` and ``nbytes`` at
    3.35 TB/s, and which of the two bounds it."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


def queued_ms(fn, iters: int, calls: int = 1, warmup: int = 3) -> float:
    """Device milliseconds per call of ``fn`` (which makes ``calls``
    wrapper calls) without host gaps: the calls are enqueued behind a
    device-side sleep that outlasts their host time (about 0.2 ms a
    wrapper call at 2 GHz), so the CUDA events around them bracket
    back-to-back device work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * calls * 4e5))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_op(fn, plain, library, flops, nbytes, peak, match, iters,
            calls=1, kernels_per_call=1):
    """``ms``: events around calls through the wrapper, host included;
    ``device_ms``: the same calls queued behind a device sleep;
    ``profiler_ms``: the profiler's kernel time a call, with the kernel
    records it found and the launches made while it traced."""
    b, by = bound(flops, nbytes, peak)
    n_prof = max(2, iters // 2)
    prof = profile_device_ms(fn, iters=n_prof, match=match)
    return {"ms": cuda_ms(fn, iters=iters),
            "device_ms": queued_ms(fn, iters=iters, calls=calls),
            "profiler_ms": prof["device_ms"],
            "profiler_records": f"{prof['records']} of "
                                f"{n_prof * kernels_per_call}",
            "plain_ms": cuda_ms(plain, iters=max(2, iters // 2), warmup=1),
            "library_ms": None if library is None
            else cuda_ms(library, iters=iters),
            "bound_ms": b, "bound_by": by}


def time_slice(slice_run) -> dict:
    """Times at the main path's shapes: CUDA events around repeated calls
    after a warm-up; device time from the profiler's trace of the kernel
    names; bound from this run's inputs."""
    import torch.nn.functional as tf
    from repro_torch.kernels import ops, ref
    out = {}
    for (name, shapes), (model, args, kwargs) in \
            slice_run["inputs"].items():
        label = f"{name} {shapes}"
        if model != "qwen3_0_6b" and label not in HEADLINE.values():
            continue      # ResNet-50's calls are timed as whole sequences
        if name == "matmul":
            a, b = args[:2]
            (m, k), n = a.shape, b.shape[1]
            peak = BF16_OPS_PER_S if a.dtype == torch.bfloat16 \
                else SCALAR_OPS_PER_S
            c_bytes = m * n * a.element_size()
            out[label] = time_op(
                lambda: ops.matmul(*args, **kwargs),
                lambda: ref.matmul_ref(a, b), lambda: torch.matmul(a, b),
                2.0 * m * n * k, _nbytes(a, b) + c_bytes, peak, "mm_",
                iters=10 if n > 100_000 else 20)
        elif name == "fused_add_rmsnorm":
            x, r, s = args[:3]
            out[label] = time_op(
                lambda: ops.fused_add_rmsnorm(*args, **kwargs),
                lambda: ref.fused_add_rmsnorm_ref(x, r, s), None,
                5.0 * x.numel(), 2 * _nbytes(x, r) + _nbytes(s),
                SCALAR_OPS_PER_S, "addnorm", iters=50)
        elif name == "flash_attention":
            q, k, v, h, kv = args[:5]
            bh, s, d = q.shape
            pairs = bh * s * (s + 1) // 2            # causal: k_pos <= q_pos
            qb, kb = q.view(bh // h, h, s, d), k.view(bh // h, kv, s, d)
            vb = v.view(bh // h, kv, s, d)
            out[label] = time_op(
                lambda: ops.flash_attention(*args, **kwargs),
                lambda: ref.flash_attention_ref(q, k, v, h, kv, True),
                lambda: tf.scaled_dot_product_attention(
                    qb, kb, vb, is_causal=True, enable_gqa=True),
                4.0 * d * pairs, 2 * _nbytes(q) + _nbytes(k, v),
                BF16_OPS_PER_S, "flash_fwd", iters=20)
        else:
            x, g, b = args[:3]
            out[label] = time_op(
                lambda: ops.bn_forward(*args, **kwargs),
                lambda: ref.bn_forward_ref(x, g, b),
                lambda: tf.batch_norm(x, None, None, g, b, training=True),
                7.0 * x.numel(), 2 * _nbytes(x) + _nbytes(g, b) + 8 * g.numel(),
                SCALAR_OPS_PER_S, "bn_", iters=20, kernels_per_call=3)
    # the whole ResNet-50 sequences, 53 BN layers and 54 GEMMs
    from repro_torch.kernels import forward as F
    calls, rinputs = slice_run["resnet"]
    for kind, lib in (("bn_forward", lambda x, g, b: tf.batch_norm(
            x, None, None, g, b, training=True)), ("matmul", torch.matmul)):
        seq = [c for c in calls if c[0] == kind]
        flops = sum(2.0 * m * k * n for _, _, (m, k, n) in seq) \
            if kind == "matmul" else sum(7.0 * n * c for _, _, (n, c) in seq)
        nbytes = 0
        for _, _, shape in seq:
            ins = rinputs[shape]
            if kind == "matmul":
                nbytes += _nbytes(*ins) + shape[0] * shape[2] * 2
            else:
                nbytes += 2 * _nbytes(ins[0]) + _nbytes(*ins[1:]) \
                    + 8 * shape[1]
        out[f"resnet50 all {len(seq)} {kind}"] = time_op(
            lambda s=seq: F.resnet50_forward(s, rinputs),
            lambda s=seq: F.resnet50_forward(s, rinputs, impl=F.PLAIN),
            lambda s=seq, f=lib: [f(*rinputs[sh]) for _, _, sh in s],
            flops, nbytes,
            BF16_OPS_PER_S if kind == "matmul" else SCALAR_OPS_PER_S,
            "mm_" if kind == "matmul" else "bn_", iters=5,
            calls=len(seq),
            kernels_per_call=len(seq) * (1 if kind == "matmul" else 3))
    return out


def time_tiles(slice_run) -> dict:
    """Device milliseconds (calls queued behind a device sleep) of every
    compiled GEMM tile at each bf16 GEMM shape of the main path, beside
    the tile the model (``gpu_model.select_matmul_block``) picks; and the
    sums over the shapes for the model's pick, the fastest tile of each
    shape and each fixed tile."""
    from repro_torch.core.gpu_model import MATMUL_TILES, select_matmul_block
    from repro_torch.kernels import matmul as mm
    shapes = {}
    for (name, _), (_, args, _) in slice_run["inputs"].items():
        if name == "matmul":
            a, b = args[:2]
            shapes[(a.shape[0], a.shape[1], b.shape[1])] = (a, b)
    per, sums = {}, {"model": 0.0, "fastest": 0.0}
    sums.update({str(t): 0.0 for t in MATMUL_TILES})
    for (m, k, n), (a, b) in shapes.items():
        blk = select_matmul_block(m, n, k, bytes_in=2, bytes_out=2)
        pick = (blk.bm, blk.bn, blk.bk)
        ms = {t: queued_ms(lambda t=t: mm.matmul(a, b, *t),
                           iters=3 if n > 100_000 else 10, warmup=1)
              for t in MATMUL_TILES}
        fastest = min(ms, key=ms.get)
        per[str((m, k, n))] = {"model_tile": str(pick),
                               "model_ms": ms[pick],
                               "fastest_tile": str(fastest),
                               "fastest_ms": ms[fastest],
                               "ms": {str(t): v for t, v in ms.items()}}
        sums["model"] += ms[pick]
        sums["fastest"] += ms[fastest]
        for t, v in ms.items():
            sums[str(t)] += v
    return {"shapes": per, "sum_ms": sums}


# the shape each kernel's line of the JSON report is timed at
HEADLINE = {
    "matmul": "matmul ((4096, 1024), (1024, 151936))",
    "fused_add_rmsnorm": "fused_add_rmsnorm ((4096, 1024), (4096, 1024), "
                         "(1024,))",
    "flash_attention": "flash_attention ((32, 2048, 128), (16, 2048, 128), "
                       "(16, 2048, 128))",
    "bn_forward": "bn_forward ((401408, 64), (64,), (64,))",
}


def kernel_slice(device, card, report) -> list:
    """Drive, hold and time the kernel slice; the JSON entries of its four
    kernels."""
    run = drive_slice(device)
    report["slice_launches"] = run["launches"]
    report["slice_launches_per_forward"] = run["per_forward"]
    report["slice_wall_s"] = run["wall_s"]
    print(f"slice launches (counters 0 before each model): "
          f"{run['launches']}")
    for model, s in run["wall_s"].items():
        print(f"  first {model} forward through ops: {s} s  [{card}]")
    held = hold_slice(run, device)
    checks = {name: len(held["held"].cases[name]) for name in OPS}
    report["slice_checks"] = {name: held["held"].cases[name] for name in OPS}
    report["decoder_bf16_rel_err"] = held["decoder_bf16_rel_err"]
    report["decoder_f32_small_max_err"] = held["decoder_f32_small_max_err"]
    report["attention_row_rel_err"] = held["held"].row_rel
    print(f"kernels == plain versions within tolerance: {checks} cases; "
          f"bf16 decoder logits relative error "
          f"{held['decoder_bf16_rel_err']} (limit {SLICE_BF16_REL}); "
          f"f32 small decoder max abs err "
          f"{held['decoder_f32_small_max_err']}")
    for label, rel in held["held"].row_rel.items():
        print(f"  {label}: relative error {rel} (worst row limit "
              f"{ATTN_BF16_ROW_REL})")
    times = time_slice(run)
    report["slice_times"] = times
    for label, t in times.items():
        print(f"  {label}: " + ", ".join(f"{k} {v}" for k, v in t.items())
              + f"  [{card}]")
    tiles = time_tiles(run)
    report["matmul_tiles"] = tiles
    for shape, row in tiles["shapes"].items():
        print(f"  matmul tiles {shape}: model {row['model_tile']} "
              f"{row['model_ms']} ms, fastest {row['fastest_tile']} "
              f"{row['fastest_ms']} ms  [{card}]")
    print(f"  matmul tiles, sum over {len(tiles['shapes'])} shapes (ms): "
          f"{tiles['sum_ms']}  [{card}]")
    entries = []
    for name in ("matmul", "fused_add_rmsnorm", "bn_forward",
                 "flash_attention"):
        source, replaces = KERNEL_META[name]
        t = times[HEADLINE[name]]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(per[name] for per in run["launches"].values()),
            "checks": checks[name],
            "max_abs_err": held["held"].max_err(name),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "profiler_ms": t["profiler_ms"], "timed_on": HEADLINE[name]})
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _ext

    # float32 references on the card run in full float32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    report = {"card": card, "kind": kind, "torch": torch.__version__,
              "cuda": torch.version.cuda, "python": sys.version.split()[0]}
    print(f"card: {card}")
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {report['python']}")

    t0 = time.perf_counter()
    report["build_s_each"] = _ext.build_all()
    report["build_s"] = time.perf_counter() - t0
    report["ptxas"] = {}
    print(f"build: {len(report['build_s_each'])} sources in parallel in "
          f"{report['build_s']} s")
    for source, secs in report["build_s_each"].items():
        ptxas = [ln.strip() for ln in _ext.BUILD_LOGS.get(source, "")
                 .splitlines() if "registers" in ln or "spill" in ln]
        report["ptxas"][source] = ptxas
        print(f"  {source}: {secs} s -> "
              f"{_ext.library_path(source).relative_to(ROOT)}")
        for ln in ptxas:
            print(f"    ptxas: {ln}")

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
              f"(device {t['device_ms']} ms, profiler {t['profiler_ms']} "
              f"ms from {t['profiler_records']} records), plain "
              f"{t['plain_ms']} ms, bound {t['bound_ms']} ms "
              f"({t['bound_by']}), gathered-bytes bound "
              f"{t['gathered_bytes_bound_ms']} ms  [{card}]")
    report["search_ms"] = time_searches(device)
    for label, row in report["search_ms"].items():
        print(f"  warm search {label}: " + ", ".join(
            f"{k} {v}" for k, v in row.items()) + f"  [{card}]")

    slice_entries = kernel_slice(device, card, report)

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
        "device_ms": t["device_ms"], "profiler_ms": t["profiler_ms"],
        "shape": t["shape"], "timed_on": main_label,
    }] + slice_entries}
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

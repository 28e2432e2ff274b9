"""A traced segment and what the benchmark reads from it.

``profile(fn)`` runs ``fn`` under ``torch.profiler`` (host and device
activity) inside a ``portbench.segment`` annotation, which marks the
traced window on the profiler's clock.  ``reduce`` takes the raw records:

* device busy seconds: the union of every device record's interval;
* device seconds by group: the port's kernels by the names their CUDA
  sources give them (``GROUPS``), everything else ``plain``;
* the device records (kernels, copies, sets) counted;
* the 10 device operations with the most time (names ``short``), and
  the idle gaps summed by what the host was doing: the innermost host
  record open at the gap's middle (``idle`` where none is).
"""
from __future__ import annotations

import bisect
import re
from typing import Dict, List, Tuple

SEGMENT = "portbench.segment"
LABELLED_GAPS = 400
# the port's kernels by the names in kernels/csrc/*.cu
GROUPS = (("matmul", ("mm_bf16<", "mm_f32<", "mm_wgmma<", "splitk_sum<")),
          ("bn_forward", ("bn_forward_kernel",)),
          ("bn_backward", ("bn_backward_kernel",)),
          ("flash_attention", ("flash_fwd",)),
          ("fused_add_rmsnorm", ("addnorm<",)))


# what a kernel's name repeats without telling kernels apart
NOISE = re.compile(r"at::native::|\(anonymous namespace\)::|void |std::|c10::"
                   r"|::operator\(\)\(\) const")
SHORT = 200


def short(name: str) -> str:
    """A kernel's name as the breakdown gives it: namespaces dropped,
    cut to ``SHORT`` characters."""
    return NOISE.sub("", name)[:SHORT]


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "plain"


def profile(fn) -> Tuple[list, list]:
    """``fn()`` traced; returns the device records and host records, each
    ``(name, start_ns, end_ns)``."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(SEGMENT):
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() != cuda:
            host.append(rec)
        elif not _annotation(e):
            device.append(rec)
    return device, host


def _annotation(event) -> bool:
    """A span's shadow on the device's timeline (``record_function``
    annotations are drawn there too), which is no device work."""
    flag = getattr(event, "is_user_annotation", None)
    return event.name() == SEGMENT or bool(flag and flag())


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def innermost(host: List[Tuple[str, int, int]], starts: List[int],
              t: int, reach: int = 4000) -> str:
    """The host record open at ``t`` that began last (``host`` sorted by
    start, ``starts`` its starts)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - reach), -1):
        name, a, b = host[j]
        if a <= t <= b and name != SEGMENT:
            return name
    return "idle"


def reduce(device: list, host: list) -> dict:
    """Seconds busy, window, by group; records; top operations; idle gaps
    by host activity (see the module's docstring)."""
    seg = [(a, b) for n, a, b in host if n == SEGMENT]
    if not seg:
        raise RuntimeError("the traced segment's annotation is missing")
    w0, w1 = seg[0]
    inside = [(n, a, b) for n, a, b in device if b > w0 and a < w1]
    spans = union([(max(a, w0), min(b, w1)) for _, a, b in inside])
    busy = sum(b - a for a, b in spans)
    by_group: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    for n, a, b in inside:
        g = group_of(n)
        by_group[g] = by_group.get(g, 0.0) + (b - a) / 1e9
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e9
    host = sorted((h for h in host if h[0] != SEGMENT), key=lambda h: h[1])
    starts = [h[1] for h in host]
    edges = [(w0, w0)] + spans + [(w1, w1)]
    holes = sorted(((start - end, end, start) for (_, end), (start, _)
                    in zip(edges, edges[1:]) if start > end), reverse=True)
    gaps: Dict[str, float] = {}
    for rank, (length, end, start) in enumerate(holes):
        # the longest gaps named by the host's work, the rest together
        what = innermost(host, starts, (start + end) // 2) \
            if rank < LABELLED_GAPS else "shorter gaps"
        gaps[what] = gaps.get(what, 0.0) + length / 1e9
    return {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
            "group_s": by_group, "records": len(inside),
            "device_ops": [(short(n), t) for n, t in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10]}

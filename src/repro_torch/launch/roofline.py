"""Roofline of one step from the cost walker's counts: the port of the
JAX package's ``launch/roofline.py``.

``collective_bytes``: the port's own copy of the reference's parser of
XLA's optimized HLO text (text in, numbers out): it sums the output
operand sizes of every all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute instruction (async ``-start`` forms
counted once), multiplying while-loop bodies by their trip count.
``analyze`` assembles the three-term roofline of
``repro_torch.core.gpu_model`` plus the MODEL_FLOPS/FLOPs usefulness
ratio from a ``launch.costmodel.Cost``; ``count_params`` counts a
``ParamDef`` tree.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Optional, Tuple

from ..core.gpu_model import RooflineTerms, model_flops
from ..models.common import ParamDef

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
}

_COLL = re.compile(
    r"=\s+(?:\(([^)]*)\)|(\w+)\[([\d,]*)\][^ ]*)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
_SHAPE = re.compile(r"(\w+)\[([\d,]*)\]")
_COMP_HDR = re.compile(r"^(?:ENTRY\s+)?%([\w.\-]+)\s*\(")
_CALLS = re.compile(r"(?:calls|to_apply)=%?([\w.\-]+)")
_WHILE = re.compile(r"while\(.*?\),.*?condition=%?([\w.\-]+),"
                    r"\s*body=%?([\w.\-]+)")
_WHILE2 = re.compile(r"while\(.*?\),.*?body=%?([\w.\-]+),"
                     r"\s*condition=%?([\w.\-]+)")
_CONST = re.compile(r"constant\((\d+)\)")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * DTYPE_BYTES.get(dtype, 4)


def _split_computations(hlo_text: str) -> Dict[str, list]:
    comps: Dict[str, list] = {}
    cur: Optional[str] = None
    for line in hlo_text.splitlines():
        m = _COMP_HDR.match(line.strip()) if line and not line.startswith(
            " ") else None
        if m and line.rstrip().endswith("{"):
            cur = m.group(1)
            comps[cur] = []
            if line.lstrip().startswith("ENTRY"):
                comps["__entry__"] = comps[cur]
        elif cur is not None:
            if line.startswith("}"):
                cur = None
            else:
                comps[cur].append(line)
    return comps


def _line_coll_bytes(line: str) -> Tuple[int, Optional[str]]:
    if "-done(" in line:
        return 0, None
    m = _COLL.search(line)
    if not m:
        return 0, None
    tuple_part, dtype, dims, kind = m.groups()
    if tuple_part is not None:
        sz = sum(_shape_bytes(dt, dm) for dt, dm in _SHAPE.findall(tuple_part))
    else:
        sz = _shape_bytes(dtype, dims)
    return sz, kind


def collective_bytes(hlo_text: str) -> Tuple[int, Dict[str, int]]:
    """Total bytes and per-kind breakdown of collective outputs,
    **multiplying while-loop (scan) bodies by their trip count** (parsed
    from the largest integer constant in the loop condition -- XLA's scan
    lowering compares the induction variable against the length)."""
    comps = _split_computations(hlo_text)
    if not comps:
        comps = {"__entry__": hlo_text.splitlines()}

    def trip_count(cond_name: str) -> int:
        names = [cond_name]
        for line in comps.get(cond_name, []):
            names += _CALLS.findall(line)
        consts = [int(c) for n in names for line in comps.get(n, [])
                  for c in _CONST.findall(line)]
        return max(consts) if consts else 1

    def walk(name: str, seen=()) -> Tuple[int, Dict[str, int]]:
        if name in seen:
            return 0, {}
        total = 0
        by_kind: Dict[str, int] = {}
        for line in comps.get(name, []):
            sz, kind = _line_coll_bytes(line)
            if sz:
                total += sz
                by_kind[kind] = by_kind.get(kind, 0) + sz
            m = _WHILE.search(line) or _WHILE2.search(line)
            if m:
                g = m.groups()
                cond, body = (g[0], g[1]) if _WHILE.search(line) else (
                    g[1], g[0])
                t = trip_count(cond)
                sub_total, sub_kind = walk(body, seen + (name,))
                total += sub_total * t
                for k, v in sub_kind.items():
                    by_kind[k] = by_kind.get(k, 0) + v * t
        return total, by_kind

    return walk("__entry__")


def analyze(cost, chips: int, n_active_params: int, tokens: int,
            training: bool, collective_bytes: Optional[float] = None,
            by_kind: Optional[Dict[str, float]] = None) -> Dict:
    """Roofline terms + usefulness ratio for one step, from the walker's
    ``cost`` (FLOPs and HBM bytes of the global program).

    The reference's ``xla_flops_body_once`` / ``xla_bytes_body_once``
    (XLA's ``cost_analysis``, a lower bound it records beside the
    walker's) have no counterpart: the port compiles no program, so
    they are absent.  ``collective_bytes`` None leaves the collective
    term out (``RooflineTerms``); ``by_kind`` is its split by collective
    (``collective_by_kind``, None without one)."""
    terms = RooflineTerms(flops=cost.flops, hbm_bytes=cost.bytes,
                          collective_bytes=collective_bytes, chips=chips)
    mf = model_flops(n_active_params, tokens, training)
    out = terms.as_dict()
    out["model_flops"] = mf
    out["model_flops_ratio"] = (mf / cost.flops) if cost.flops else 0.0
    out["gemm_flops"] = cost.gemm_flops
    # the reference parses the kinds from the compiled program's HLO;
    # the port reads them from its partitioned step (launch/program.py)
    out["collective_by_kind"] = by_kind
    return out


def count_params(defs_tree, moe_scale: Optional[Dict[str, float]] = None
                 ) -> Tuple[int, int]:
    """(total, active) parameter counts from a ParamDef tree.

    ``active`` scales expert-axis parameters by (top_k [+ shared]) / E.
    """
    total = active = 0
    stack = [defs_tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
            continue
        if not isinstance(node, ParamDef):
            raise TypeError(f"count_params: a leaf of {type(node)}, not "
                            f"a ParamDef")
        n = math.prod(node.shape)
        total += n
        scale = 1.0
        if "experts" in node.axes and moe_scale:
            scale = moe_scale.get("expert_frac", 1.0)
        active += int(n * scale)
    return total, active

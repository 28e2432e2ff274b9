#!/usr/bin/env python3
"""The ops of one step of a ``chip_smoke.py`` phase-22 cell whose peak
allocation on the card exceeds the new storages they return: temporaries
that a dispatch mode, and so the meta-device reckoning
(``chip_smoke.meta_peak_bytes``), cannot see.  Needs a CUDA card.

    PYTHONPATH=src python scripts/op_temporaries.py \
        [--cell train_4k|prefill_32k|decode_32k] [--min-mb 50]

Qwen3-0.6B at full size on the cell (``chip_smoke.DRY_CELLS``, the
kernel route, ``chip_smoke.dry_inputs``): one warm step, then a second
step under a ``TorchDispatchMode`` that reads the allocator's peak
around each op.  Prints one JSON object: the state's bytes, the step's
peak allocated bytes and the op at it, and for each op whose peak
exceeds its new outputs by more than ``--min-mb`` MB, the largest excess
and the number of such calls.
"""
from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def hidden_temporaries(cell: str, min_bytes: float) -> dict:
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.kernels import _ext
    from repro_torch.launch.shapes import SHAPES, adjust_config
    smoke = _smoke()
    _ext.build_all()
    batch = dict(smoke.DRY_CELLS)[cell]
    shape = SHAPES[cell]
    cfg = adjust_config(get_config(smoke.DRY_ARCH), shape)
    step, state, x = smoke.dry_inputs(cfg, shape.kind, batch, shape.seq,
                                      torch.device("cuda"))
    box = [state]
    del state
    box[0], _ = step(box[0], x)
    torch.cuda.synchronize()
    excess, calls = collections.Counter(), collections.Counter()
    peak = {"bytes": 0, "op": None}

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            res = func(*args, **(kwargs or {}))
            top = torch.cuda.max_memory_allocated()
            seen = {t.untyped_storage()._cdata for t in tree_leaves(
                (args, kwargs)) if isinstance(t, torch.Tensor)}
            made = 0
            for t in tree_leaves(res):
                if isinstance(t, torch.Tensor) and \
                        t.untyped_storage()._cdata not in seen:
                    seen.add(t.untyped_storage()._cdata)
                    made += t.untyped_storage().nbytes()
            if top > peak["bytes"]:
                peak.update(bytes=top, op=str(func))
            if top - before - made > min_bytes:
                excess[str(func)] = max(excess[str(func)],
                                        top - before - made)
                calls[str(func)] += 1
            return res

    base = torch.cuda.memory_allocated()
    with Ops():
        box[0], _ = step(box[0], x)
    torch.cuda.synchronize()
    return {"cell": cell, "batch": batch, "seq": shape.seq,
            "allocated_before_gb": base / 1e9,
            "peak_gb": peak["bytes"] / 1e9, "peak_op": peak["op"],
            "hidden": [{"op": op, "excess_gb": n / 1e9, "calls": calls[op]}
                       for op, n in excess.most_common()],
            "card": torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default="train_4k",
                    choices=("train_4k", "prefill_32k", "decode_32k"))
    ap.add_argument("--min-mb", type=float, default=50.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("op_temporaries: needs a CUDA card", file=sys.stderr)
        return 1
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    print(json.dumps(hidden_temporaries(args.cell, args.min_mb * 1e6)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

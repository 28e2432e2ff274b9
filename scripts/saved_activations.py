#!/usr/bin/env python3
"""Bytes a float32 training step of the port's ``Model`` keeps for its
backward, counted on the meta device (no memory is allocated, no card is
needed).

    PYTHONPATH=src python scripts/saved_activations.py ARCH \
        [--layers N] [--batch 4] [--seq 1024] [--plain]

``Model.loss`` of ``get_config(ARCH)`` (full width; ``--layers`` cuts the
depth) on a (batch, seq) token batch, through ``ops.differentiable`` over
the plain versions (the kernel route's autograd functions, which save
their inputs) or with ``--plain`` through the plain versions themselves
(autograd then also saves attention's probabilities).  Every tensor
autograd saves is counted once by its storage: views of one tensor count
once.  Prints one JSON object: the saved bytes, the parameter count and
the bytes AdamW's state takes beside them (parameters, gradients and two
moments, 16 bytes a parameter), and the largest saved tensors by shape
and the lines that saved them.  A step's peak is above the sum: the
backward's transients (the logits' gradient, the transposed copies of
``MatmulFn``) come on top.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import traceback
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import forward as F  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402


def saved_bytes(arch: str, layers: int, batch: int, seq: int,
                plain: bool) -> dict:
    cfg = get_config(arch).replace(dtype=torch.float32, remat=False)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    model = Model(cfg, impl=F.PLAIN if plain else ops.differentiable(F.PLAIN))
    params = tree_map(lambda d: torch.empty(d.shape, device="meta")
                      .requires_grad_(), model.param_defs())
    seen, by_site = {}, collections.Counter()

    def pack(t):
        base = t._base if t._base is not None else t
        if id(base) not in seen:
            seen[id(base)] = base          # kept, so that ids stay unique
            sites = [f"{Path(f.filename).name}:{f.lineno}"
                     for f in traceback.extract_stack()
                     if "repro_torch" in f.filename][-2:]
            by_site[(tuple(base.shape), " ".join(sites))] += \
                base.numel() * base.element_size()
        return t
    tokens = torch.zeros((batch, seq), dtype=torch.int64, device="meta")
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.loss(params, {"tokens": tokens})
    n = model.n_params()
    return {"arch": arch, "layers": cfg.n_layers, "batch": batch,
            "seq": seq, "route": "plain" if plain else "kernels",
            "saved_gb": sum(by_site.values()) / 1e9,
            "params": n, "adamw_state_gb": 16 * n / 1e9,
            "largest": [(list(shape), site, b / 1e9) for (shape, site), b
                        in by_site.most_common(8)]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--plain", action="store_true")
    args = ap.parse_args(argv)
    print(json.dumps(saved_bytes(args.arch, args.layers, args.batch,
                                 args.seq, args.plain)))


if __name__ == "__main__":
    main()

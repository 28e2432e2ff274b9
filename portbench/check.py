"""The comparisons that decide ``correct``: each reduces what the timed
path produced, against the plain reference, to one number that the
cell's file bounds (``portbench/cells/<workload>.json``, ``limits``).

* training (``training``): each checked step's loss, as a relative gap;
  each leaf's norm of the first gradient as the optimizer got it and
  each leaf's norm of the parameters' change over the checked steps, as
  the gap between the program's norm and the reference's over the larger
  of the reference's norm of that leaf and of the median leaf, the worst
  leaf.  Leaves whose first gradient in the reference is under a
  thousandth of the median leaf's are left out of both (they move by
  round-off alone).
* answers checked row by row (``rows``): the worst row's relative
  Frobenius gap of the program's row against the reference's.
* served tokens (``token_gaps``): by how much the served token's logit
  lies below the reference's best, the widest gap.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

QUIET_LEAF = 1e-3


def leaf_gap(got: Dict[str, float], want: Dict[str, float],
             leaves: List[str]) -> float:
    median = statistics.median(want[k] for k in leaves)
    return max(abs(got[k] - want[k]) / max(want[k], median, 1e-30)
               for k in leaves)


def training(got: dict, want: dict) -> Dict[str, float]:
    """``got``, ``want``: ``losses`` (one a step), ``grad_norms`` and
    ``change_norms`` (leaf -> norm)."""
    g = want["grad_norms"]
    floor = QUIET_LEAF * statistics.median(g.values())
    leaves = sorted(k for k in g if g[k] >= floor)
    return {"loss": max(abs(a - b) / abs(b) for a, b in
                        zip(got["losses"], want["losses"])),
            "grad_norm": leaf_gap(got["grad_norms"], g, leaves),
            "change_norm": leaf_gap(got["change_norms"],
                                    want["change_norms"], leaves)}


def rows(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.double().flatten(1), want.double().flatten(1)
    return float(((g - w).norm(dim=1) / w.norm(dim=1).clamp_min(1e-30))
                 .max())


def token_gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Each row's best logit less the logit of its token."""
    lg = logits.double()
    return lg.max(-1).values - lg.gather(1, tokens.long()[:, None])[:, 0]


def held(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number finite and at most its limit (a number without a
    limit, or a limit without a number, fails)."""
    return set(numbers) == set(limits) and all(
        math.isfinite(v) and v <= limits[k] for k, v in numbers.items())

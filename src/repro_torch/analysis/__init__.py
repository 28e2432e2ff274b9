"""``repro_torch.analysis`` — static invariant checks for the port's own
source.  The port's copy of the JAX package's ``analysis``, over the
port's paths and locks (``manifest.DEFAULT_MANIFEST``), with an ``x64``
pass rewritten for torch's hazards and a determinism pass that also
knows torch's global generator.

Every fast path of the port (batched tables, the torch/torch-fused grid
backends and the CUDA grid kernel, the serving tier) is pinned
*bit-identical* to the paper's scalar reference walk.  Those pins rest
on contracts the test suite can only sample, never prove:

  * **Lock discipline** — the process-lifetime table caches, the fault
    registry, the serving-tier state and the grid kernel's workspaces
    and counters are mutated from many threads; every access must hold
    the declared lock (``# guarded-by:``), and locks must nest in one
    global order (no ABBA deadlocks).
  * **int64 exactness** — the cycle-count call graph must never
    introduce a float that cannot represent its integers exactly
    (bare ``/`` where ``//`` or a ceil-div is meant, ``np.mean``,
    non-integral float literals, float32 anywhere).
  * **int64 width** — the grid modules carry int64 cycles through torch
    (whose default float is float32) and ``ctypes``: no factory left to
    torch's defaults, no dtype, cast or C declaration narrower than 64
    bits unless waived with a reason, and no change of torch's default
    dtype anywhere.
  * **Fault-point consistency** — ``core.faultinject`` names used at
    injection sites, the registry, and the port's tests arming them must
    agree; a typo'd point silently disables a recovery test.
  * **Determinism** — pricing paths must not depend on wall-clock time,
    unseeded RNG (numpy's, Python's or torch's global generator),
    builtin ``hash`` randomization, or set iteration order; "same
    query, same answer" is the serving dedup contract.

This package machine-checks all five as AST passes —
``python -m repro_torch.analysis`` over ``src/repro_torch`` and the
port's tests ``tests/test_torch_*.py`` — with machine-readable findings
and a committed baseline (``analysis-baseline-torch.json``) so CI fails
only on *new* violations and the baseline can only ratchet down.  The
annotation grammar, the fingerprints and the baseline format are the
JAX package's, so one waiver reads the same in both packages.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence

from .manifest import DEFAULT_MANIFEST, Manifest
from .report import (Baseline, Finding, diff_against_baseline, fingerprints,
                     findings_to_json)
from .source import SourceFile, collect_sources

__all__ = [
    "Baseline", "DEFAULT_MANIFEST", "Finding", "Manifest", "SourceFile",
    "collect_sources", "diff_against_baseline", "findings_to_json",
    "fingerprints", "run_passes", "PASSES",
]


def _load_passes():
    from . import determinism, exactness, faults, locks, x64
    return (locks, exactness, x64, faults, determinism)


PASSES = tuple(p.PASS_ID for p in _load_passes())


def run_passes(files: Sequence[SourceFile],
               manifest: Manifest = DEFAULT_MANIFEST, *,
               only: Iterable[str] = ()) -> List[Finding]:
    """Run the analysis passes over ``files`` and return sorted findings.
    ``only`` restricts to a subset of pass ids (default: all)."""
    wanted = set(only)
    out: List[Finding] = []
    for mod in _load_passes():
        if wanted and mod.PASS_ID not in wanted:
            continue
        out.extend(mod.run(files, manifest))
    # drop findings the source explicitly waives on that line
    by_file = {f.rel: f for f in files}
    out = [f for f in out
           if (sf := by_file.get(f.path)) is None
           or not sf.allowed(f.line, f.code, f.pass_id)]
    return sorted(out)

"""CLI: ``python -m repro_torch.analysis [--baseline F] [paths...]``.

Runs every pass over the given paths (default ``src/repro_torch``),
auto-including the port's tests (``test_torch_*.py`` of the ``tests``
directory beside the package's ``src``, or of ``--tests``) so the
fault-coverage check sees what arms the port's fault points, and only
that: the JAX package's tests arm the JAX package's copies.  Exit status
0 means no findings outside the baseline; 1 means new violations
(printed, and written to ``--json`` if given).  ``--write-baseline``
accepts the current findings as the new baseline.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from . import (Baseline, DEFAULT_MANIFEST, PASSES, collect_sources,
               diff_against_baseline, findings_to_json, run_passes)

TEST_GLOB = "test_torch_*.py"


def _tests_dir(first: Path) -> Optional[Path]:
    """The ``tests`` directory beside ``first`` or beside its parent
    (``src/repro_torch`` -> ``tests``), if there is one."""
    first = first.resolve()
    for base in (first.parent, first.parent.parent):
        if (base / "tests").is_dir():
            return base / "tests"
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static invariant checks over the port's source tree.")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to analyze "
                         "(default: src/repro_torch)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="known-violations file; fail only on NEW findings")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the current findings to --baseline and exit")
    ap.add_argument("--json", type=Path, default=None, metavar="OUT",
                    help="write the machine-readable findings report here")
    ap.add_argument("--tests", type=Path, default=None,
                    help=f"tests directory whose {TEST_GLOB} files count "
                         f"for fault coverage (default: the 'tests' beside "
                         f"the first path or its parent)")
    ap.add_argument("--only", action="append", default=[], choices=PASSES,
                    help="run only this pass (repeatable)")
    ap.add_argument("--root", type=Path, default=None,
                    help="path-relativization root (default: cwd)")
    args = ap.parse_args(argv)

    paths = [Path(p) for p in (args.paths or ["src/repro_torch"])]
    tests = args.tests if args.tests is not None else _tests_dir(paths[0])
    test_files: List[Path] = sorted(tests.glob(TEST_GLOB)) if tests else []
    files = collect_sources(list(paths) + test_files, root=args.root)
    if not files:
        print(f"repro_torch.analysis: no python sources under {paths}",
              file=sys.stderr)
        return 2

    findings = run_passes(files, DEFAULT_MANIFEST, only=args.only)

    if args.json is not None:
        args.json.write_text(
            json.dumps(findings_to_json(findings), indent=2) + "\n")

    if args.write_baseline:
        if args.baseline is None:
            ap.error("--write-baseline requires --baseline")
        Baseline.from_findings(findings).save(args.baseline)
        print(f"wrote {len(findings)} finding(s) to {args.baseline}")
        return 0

    baseline = Baseline.load(args.baseline) if args.baseline else Baseline()
    new, stale = diff_against_baseline(findings, baseline)

    n_files = len(files)
    print(f"repro_torch.analysis: {n_files} file(s), {len(findings)} "
          f"finding(s), {len(new)} new, {len(stale)} stale baseline entr"
          f"{'y' if len(stale) == 1 else 'ies'}")
    for fp, f in sorted(new.items(), key=lambda kv: kv[1]):
        print(f"  NEW {f.render()}  [{fp}]")
    for fp in stale:
        old = baseline.findings.get(fp, {})
        loc = f"{old.get('path', '?')}:{old.get('line', '?')}"
        print(f"  stale baseline entry {fp} ({old.get('code', '?')} at "
              f"{loc}) — fixed; ratchet with --write-baseline")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())

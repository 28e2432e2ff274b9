"""Findings, fingerprints, and the baseline ratchet.

A ``Finding`` is one violation at one source location.  Its
*fingerprint* deliberately excludes the line number — it hashes the pass,
code, file, and the enclosing scope/symbol — so unrelated edits that
shift lines do not churn the baseline; only the k-th identical violation
in the same scope gets a ``#k`` suffix.  The baseline file maps
fingerprints to their last-seen location: CI fails on fingerprints not
in the baseline (*new* violations) and reports baseline entries that no
longer occur (*stale* — ratchet the file down with ``--write-baseline``).
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Dict, List, Sequence, Tuple


@dataclass(frozen=True, order=True)
class Finding:
    """One violation: location + pass/code + human message + the stable
    ``symbol`` anchor (enclosing scope and offending name) that makes its
    fingerprint survive line drift."""
    path: str                  # repo-relative posix path
    line: int
    col: int
    pass_id: str               # "locks" | "exact" | "x64" | "faults" | "determinism"
    code: str                  # e.g. "LOCK001"
    message: str
    symbol: str = ""           # "Scope.func:name" — fingerprint anchor

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"

    def render(self) -> str:
        return f"{self.location()}: {self.code} [{self.pass_id}] {self.message}"


def fingerprints(findings: Sequence[Finding]) -> Dict[str, Finding]:
    """Stable fingerprint per finding: hash of (pass, code, path, symbol)
    plus an occurrence counter for repeats of the same anchor."""
    seen: Dict[str, int] = {}
    out: Dict[str, Finding] = {}
    for f in sorted(findings):
        base = f"{f.pass_id}|{f.code}|{f.path}|{f.symbol}"
        h = hashlib.sha256(base.encode()).hexdigest()[:16]
        k = seen.get(h, 0)
        seen[h] = k + 1
        out[h if k == 0 else f"{h}#{k}"] = f
    return out


@dataclass
class Baseline:
    """The committed known-violations file (``analysis-baseline.json``)."""
    version: int = 1
    findings: Dict[str, dict] = field(default_factory=dict)

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        if not Path(path).exists():
            return cls()
        data = json.loads(Path(path).read_text())
        return cls(version=int(data.get("version", 1)),
                   findings=dict(data.get("findings", {})))

    @classmethod
    def from_findings(cls, findings: Sequence[Finding]) -> "Baseline":
        return cls(findings={fp: asdict(f)
                             for fp, f in fingerprints(findings).items()})

    def save(self, path: Path) -> None:
        payload = {"version": self.version,
                   "findings": {fp: self.findings[fp]
                                for fp in sorted(self.findings)}}
        Path(path).write_text(json.dumps(payload, indent=2,
                                         sort_keys=True) + "\n")


def diff_against_baseline(findings: Sequence[Finding], baseline: Baseline
                          ) -> Tuple[Dict[str, Finding], List[str]]:
    """``(new, stale)``: findings whose fingerprint the baseline does not
    know (CI failures), and baseline fingerprints no longer produced
    (candidates for ratcheting the baseline down)."""
    fps = fingerprints(findings)
    new = {fp: f for fp, f in fps.items() if fp not in baseline.findings}
    stale = [fp for fp in baseline.findings if fp not in fps]
    return new, stale


def findings_to_json(findings: Sequence[Finding]) -> dict:
    """Machine-readable report payload (the CI artifact)."""
    fps = fingerprints(findings)
    per_pass: Dict[str, int] = {}
    for f in findings:
        per_pass[f.pass_id] = per_pass.get(f.pass_id, 0) + 1
    return {
        "total": len(findings),
        "by_pass": per_pass,
        "findings": [dict(asdict(f), fingerprint=fp)
                     for fp, f in fps.items()],
    }

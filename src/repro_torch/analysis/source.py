"""Source loading for the analysis passes: parsed AST with parent links
plus the line-level annotations the passes consume.

Recognized trailing comments:

``# guarded-by: <lock>``
    On an assignment, declares the assigned module-global (or
    ``self.<attr>`` instance attribute) as shared state that must only
    be accessed while holding ``<lock>`` (a name like ``_CACHE_LOCK`` or
    a dotted expression like ``self._lock``).

``# holds-lock: <lock>``
    On a ``def``, declares a caller-holds-lock helper: the body is
    analyzed as if it ran inside ``with <lock>:``.  The ``_locked`` name
    suffix alone also marks a helper, but without naming the lock it
    merely exempts the body from guarded-access checks.

``# analysis: allow[CODE]`` / ``# analysis: allow[pass]``
    Waives findings with that code (or from that pass) on this line.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set

_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][\w.]*)")
_HOLDS_RE = re.compile(r"#\s*holds-lock:\s*([A-Za-z_][\w.]*)")
_ALLOW_RE = re.compile(r"#\s*analysis:\s*allow\[([^\]]+)\]")


def scope_name(node: ast.AST) -> str:
    """Dotted name of the enclosing defs/classes (fingerprint anchor)."""
    parts: List[str] = []
    n = getattr(node, "parent", None)
    while n is not None:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            parts.append(n.name)
        n = getattr(n, "parent", None)
    return ".".join(reversed(parts)) or "<module>"


def expr_text(node: ast.AST) -> str:
    """Minimal unparse for lock expressions and call targets: dotted
    Name/Attribute chains (``self._lock``, ``faultinject.fire``); other
    shapes render as ``<expr>`` and never match a declared lock."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return f"{expr_text(node.value)}.{node.attr}"
    if isinstance(node, ast.Call):
        return f"{expr_text(node.func)}()"
    return "<expr>"


@dataclass
class SourceFile:
    path: Path                       # as given (absolute or relative)
    rel: str                         # repo-relative posix path
    text: str
    tree: ast.Module
    lines: List[str] = field(default_factory=list)
    guards: Dict[int, str] = field(default_factory=dict)      # line -> lock
    holds: Dict[int, str] = field(default_factory=dict)       # line -> lock
    allow: Dict[int, Set[str]] = field(default_factory=dict)  # line -> tokens

    @classmethod
    def parse(cls, path: Path, rel: Optional[str] = None) -> "SourceFile":
        text = Path(path).read_text()
        tree = ast.parse(text, filename=str(path))
        for node in ast.walk(tree):          # parent links for scope lookup
            for child in ast.iter_child_nodes(node):
                child.parent = node          # type: ignore[attr-defined]
        sf = cls(path=Path(path), rel=rel or Path(path).as_posix(),
                 text=text, tree=tree, lines=text.splitlines())
        for i, line in enumerate(sf.lines, start=1):
            if "#" not in line:
                continue
            if (m := _GUARDED_RE.search(line)):
                sf.guards[i] = m.group(1)
            if (m := _HOLDS_RE.search(line)):
                sf.holds[i] = m.group(1)
            if (m := _ALLOW_RE.search(line)):
                sf.allow[i] = {t.strip() for t in m.group(1).split(",")}
        return sf

    def allowed(self, line: int, code: str, pass_id: str) -> bool:
        toks = self.allow.get(line, ())
        return bool(toks) and bool({code, pass_id, "*"} & set(toks))

    def matches(self, suffix: str) -> bool:
        """Path-suffix match used by the manifest scoping (so
        ``repro_torch/core/dse.py`` matches ``src/repro_torch/core/dse.py``)."""
        return self.rel.endswith(suffix)


def collect_sources(paths: Iterable[Path],
                    root: Optional[Path] = None) -> List[SourceFile]:
    """Parse every ``.py`` under ``paths`` (files or directories),
    relativized against ``root`` (default: cwd) for stable finding
    paths.  Files that fail to parse are skipped — syntax errors are the
    interpreter's job, not this suite's."""
    root = Path(root) if root is not None else Path.cwd()
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    out: List[SourceFile] = []
    for f in files:
        try:
            rel = f.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = f.as_posix()
        try:
            out.append(SourceFile.parse(f, rel=rel))
        except SyntaxError:
            continue
    return out

"""Pass 1 — lock-discipline race detector.

Checks three things over the ``# guarded-by:`` registry (see
``source.py`` for the annotation grammar):

``LOCK001``  a guarded module-global (or guarded ``self.<attr>``) is
             read or written outside a ``with <lock>:`` scope, outside a
             ``# holds-lock:``-annotated / ``_locked``-suffixed
             caller-holds-lock helper, and outside ``__init__``
             (construction happens-before publication).
``LOCK002``  a ``_locked``-suffixed helper is *called* while no declared
             lock is held.
``LOCK003``  lock-order violation: lock B acquired (directly or through
             a resolved call) while holding lock A, where the manifest's
             global order does not place A strictly before B — the
             static ABBA/deadlock check.
``LOCK004``  a ``guarded-by``/``holds-lock`` annotation names a lock
             never acquired anywhere in that file (typo guard).

Scope rules are conservative and syntactic: entering a nested ``def`` or
``lambda`` clears the held-lock stack (closures execute later, not under
the enclosing ``with``), and module/class body statements are exempt
(import is single-threaded).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .manifest import Manifest
from .report import Finding
from .source import SourceFile, expr_text

PASS_ID = "locks"


@dataclass
class _Guard:
    name: str                  # global name, or attr for instance guards
    lock: str                  # lock expression text as annotated
    cls: Optional[str] = None  # owning class for self.<attr> guards
    line: int = 0


@dataclass
class _Func:
    qual: str                  # "<rel>:<Class.>name"
    node: ast.AST
    sf: SourceFile
    cls: Optional[str]
    direct_locks: Set[str] = field(default_factory=set)   # lock ids
    calls: List[str] = field(default_factory=list)        # rendered call texts


def _lock_id(sf: SourceFile, cls: Optional[str], text: str) -> str:
    """Canonical id of a lock expression in a given file/class scope."""
    if text.endswith("()"):
        text = text[:-2]
    if text.startswith("self.") and cls:
        return f"{sf.rel}:{cls}.{text}"
    return f"{sf.rel}:{text}"


def _order_index(manifest: Manifest, lock_id: str) -> Optional[int]:
    """Position of a lock in the declared total order.  Matching is by
    the name part — a lock imported into another file keeps its
    identity — with the path part disambiguating duplicate names."""
    lpath, _, lname = lock_id.partition(":")
    cands = [(i, e) for i, e in enumerate(manifest.lock_order)
             if e.partition(":")[2] == lname]
    if len(cands) == 1:
        return cands[0][0]
    for i, e in cands:
        if lpath.endswith(e.partition(":")[0]):
            return i
    return None


def _collect_guards(sf: SourceFile) -> Tuple[Dict[str, _Guard],
                                             Dict[Tuple[str, str], _Guard]]:
    """(module-global guards by name, instance guards by (class, attr))."""
    globals_: Dict[str, _Guard] = {}
    instance: Dict[Tuple[str, str], _Guard] = {}
    for node in ast.walk(sf.tree):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        lock = sf.guards.get(node.lineno)
        if lock is None:
            continue
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        cls = _enclosing_class(node)
        for t in targets:
            if isinstance(t, ast.Name) and cls is None:
                globals_[t.id] = _Guard(t.id, lock, line=node.lineno)
            elif (isinstance(t, ast.Attribute)
                  and isinstance(t.value, ast.Name)
                  and t.value.id == "self" and cls is not None):
                instance[(cls, t.attr)] = _Guard(t.attr, lock, cls,
                                                 node.lineno)
    return globals_, instance


def _enclosing_class(node: ast.AST) -> Optional[str]:
    n = getattr(node, "parent", None)
    while n is not None:
        if isinstance(n, ast.ClassDef):
            return n.name
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # keep climbing: methods report their class
            pass
        n = getattr(n, "parent", None)
    return None


def _functions(sf: SourceFile) -> List[_Func]:
    out = []
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            cls = _enclosing_class(node)
            qual = f"{sf.rel}:{cls + '.' if cls else ''}{node.name}"
            out.append(_Func(qual, node, sf, cls))
    return out


def _is_exempt(fn: ast.AST, sf: SourceFile, manifest: Manifest) -> bool:
    name = getattr(fn, "name", "")
    if name in ("__init__", "__del__", "__new__"):
        return True
    return (name.endswith(manifest.locked_suffix)
            and fn.lineno not in sf.holds)


class _FnVisitor(ast.NodeVisitor):
    """Walks ONE function body tracking the held-lock stack; records
    guarded accesses, direct acquisitions, and rendered calls."""

    def __init__(self, fn: _Func, manifest: Manifest,
                 globals_: Dict[str, _Guard],
                 instance: Dict[Tuple[str, str], _Guard]):
        self.fn = fn
        self.manifest = manifest
        self.globals = globals_
        self.instance = instance
        self.held_texts: List[str] = []      # lock exprs as written
        self.violations: List[Finding] = []
        held = fn.sf.holds.get(fn.node.lineno)
        if held is not None:
            self.held_texts.append(held)
        self.exempt = _is_exempt(fn.node, fn.sf, manifest)

    # -- helpers ------------------------------------------------------------

    def _finding(self, node: ast.AST, code: str, msg: str,
                 symbol: str) -> None:
        self.violations.append(Finding(
            self.fn.sf.rel, node.lineno, node.col_offset, PASS_ID, code,
            msg, symbol=f"{self.fn.qual}:{symbol}"))

    def _holding(self, lock_text: str) -> bool:
        return lock_text in self.held_texts

    # -- traversal ----------------------------------------------------------

    def run(self) -> None:
        node = self.fn.node
        for stmt in node.body:
            self.visit(stmt)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # nested defs execute later, not under the enclosing with
        return

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        return

    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        for item in node.items:
            text = expr_text(item.context_expr)
            if text.endswith("()"):
                base = text[:-2]
                if base.split(".")[-1].endswith(self.manifest.locked_suffix):
                    self.held_texts.append(text)
                    pushed += 1
            else:
                self.held_texts.append(text)
                pushed += 1
            lock_id = _lock_id(self.fn.sf, self.fn.cls, text)
            if _order_index(self.manifest, lock_id) is not None:
                self.fn.direct_locks.add(lock_id)
                self._order_check(node, lock_id, pushed)
        for stmt in node.body:
            self.visit(stmt)
        del self.held_texts[len(self.held_texts) - pushed:]

    def _order_check(self, node: ast.AST, acquired: str,
                     pushed_now: int) -> None:
        ai = _order_index(self.manifest, acquired)
        for held_text in self.held_texts[:len(self.held_texts) - pushed_now]:
            held_id = _lock_id(self.fn.sf, self.fn.cls, held_text)
            hi = _order_index(self.manifest, held_id)
            if hi is None or held_id == acquired:
                continue
            if ai is not None and hi >= ai:
                self._finding(
                    node, "LOCK003",
                    f"acquires {acquired.split(':')[-1]} while holding "
                    f"{held_id.split(':')[-1]}: violates the declared lock "
                    f"order", symbol=f"{held_id}->{acquired}")

    def visit_Call(self, node: ast.Call) -> None:
        text = expr_text(node.func)
        self.fn.calls.append(text)
        callee = text.split(".")[-1]
        if (callee.endswith(self.manifest.locked_suffix)
                and not self.held_texts and not self.exempt
                and not isinstance(getattr(node, "parent", None), ast.With)
                and not (isinstance(getattr(node, "parent", None),
                                    ast.withitem))):
            self._finding(node, "LOCK002",
                          f"call to caller-holds-lock helper {callee!r} "
                          f"with no lock held", symbol=callee)
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        g = self.globals.get(node.id)
        if g is not None and not self.exempt \
                and node.lineno != g.line and not self._holding(g.lock):
            self._finding(node, "LOCK001",
                          f"access to {node.id!r} (guarded by {g.lock}) "
                          f"without holding the lock", symbol=node.id)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (isinstance(node.value, ast.Name) and node.value.id == "self"
                and self.fn.cls is not None):
            g = self.instance.get((self.fn.cls, node.attr))
            if g is not None and not self.exempt \
                    and node.lineno != g.line \
                    and not self._holding(g.lock):
                self._finding(
                    node, "LOCK001",
                    f"access to self.{node.attr!r} (guarded by {g.lock}) "
                    f"without holding the lock", symbol=f"self.{node.attr}")
        self.generic_visit(node)


def _resolve_call(text: str, fn: _Func, funcs_by_qual: Dict[str, _Func],
                  by_file_name: Dict[Tuple[str, str], _Func],
                  by_stem_name: Dict[Tuple[str, str], _Func],
                  manifest: Manifest) -> Optional[_Func]:
    hint = manifest.call_patterns.get(text)
    if hint is not None:
        hpath, _, hname = hint.partition(":")
        for qual, f in funcs_by_qual.items():
            qpath, _, qname = qual.partition(":")
            if qname == hname and qpath.endswith(hpath):
                return f
        return None
    parts = text.split(".")
    if len(parts) == 1:
        return by_file_name.get((fn.sf.rel, parts[0]))
    if parts[0] == "self" and len(parts) == 2 and fn.cls:
        return funcs_by_qual.get(f"{fn.sf.rel}:{fn.cls}.{parts[1]}")
    if len(parts) == 2:
        return by_stem_name.get((parts[0], parts[1]))
    return None


def run(files: Sequence[SourceFile], manifest: Manifest) -> List[Finding]:
    findings: List[Finding] = []
    all_funcs: List[_Func] = []
    for sf in files:
        globals_, instance = _collect_guards(sf)
        funcs = _functions(sf)
        all_funcs.extend(funcs)
        if globals_ or instance:
            # LOCK004: annotated locks never acquired in this file
            acquired_texts = {expr_text(i.context_expr).removesuffix("()")
                              for n in ast.walk(sf.tree)
                              if isinstance(n, ast.With) for i in n.items}
            for g in list(globals_.values()) + list(instance.values()):
                if g.lock.removesuffix("()") not in acquired_texts \
                        and g.lock not in sf.holds.values():
                    findings.append(Finding(
                        sf.rel, g.line, 0, PASS_ID, "LOCK004",
                        f"guarded-by names {g.lock!r}, which is never "
                        f"acquired in this file (typo?)",
                        symbol=f"{g.cls or ''}.{g.name}:{g.lock}"))
        for fn in funcs:
            v = _FnVisitor(fn, manifest, globals_, instance)
            v.run()
            findings.extend(v.violations)

    # ---- interprocedural lock-order edges ---------------------------------
    funcs_by_qual = {f.qual: f for f in all_funcs}
    by_file_name: Dict[Tuple[str, str], _Func] = {}
    by_stem_name: Dict[Tuple[str, str], _Func] = {}
    for f in all_funcs:
        name = f.qual.partition(":")[2].split(".")[-1]
        if f.cls is None:
            by_file_name.setdefault((f.sf.rel, name), f)
            stem = f.sf.rel.rsplit("/", 1)[-1].removesuffix(".py")
            by_stem_name.setdefault((stem, name), f)
    # transitive closure of acquired locks through resolved calls
    acquires: Dict[str, Set[str]] = {f.qual: set(f.direct_locks)
                                     for f in all_funcs}
    changed = True
    while changed:
        changed = False
        for f in all_funcs:
            for text in f.calls:
                g = _resolve_call(text, f, funcs_by_qual, by_file_name,
                                  by_stem_name, manifest)
                if g is None:
                    continue
                extra = acquires[g.qual] - acquires[f.qual]
                if extra:
                    acquires[f.qual] |= extra
                    changed = True
    # re-walk: inside each with-lock region, calls imply edges
    for f in all_funcs:
        findings.extend(_call_edges(f, acquires, funcs_by_qual,
                                    by_file_name, by_stem_name, manifest))
    return findings


def _call_edges(fn: _Func, acquires: Dict[str, Set[str]],
                funcs_by_qual, by_file_name, by_stem_name,
                manifest: Manifest) -> List[Finding]:
    """Edges lock->lock implied by calls made while a lock is held."""
    out: List[Finding] = []
    seen: Set[Tuple[str, str]] = set()

    def walk(node: ast.AST, held: List[str]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not fn.node:
            return
        if isinstance(node, ast.With):
            pushed = []
            for item in node.items:
                lock_id = _lock_id(fn.sf, fn.cls,
                                   expr_text(item.context_expr))
                if _order_index(manifest, lock_id) is not None:
                    pushed.append(lock_id)
            held = held + pushed
            for stmt in node.body:
                walk(stmt, held)
            return
        if isinstance(node, ast.Call) and held:
            g = _resolve_call(expr_text(node.func), fn, funcs_by_qual,
                              by_file_name, by_stem_name, manifest)
            if g is not None:
                for m in acquires.get(g.qual, ()):
                    for h in held:
                        if h == m or (h, m) in seen:
                            continue
                        seen.add((h, m))
                        hi, mi = (_order_index(manifest, h),
                                  _order_index(manifest, m))
                        if hi is not None and mi is not None and hi >= mi:
                            out.append(Finding(
                                fn.sf.rel, node.lineno, node.col_offset,
                                PASS_ID, "LOCK003",
                                f"call into {g.qual} acquires "
                                f"{m.split(':')[-1]} while holding "
                                f"{h.split(':')[-1]}: violates the "
                                f"declared lock order",
                                symbol=f"{fn.qual}:{h}->{m}"))
        for child in ast.iter_child_nodes(node):
            walk(child, held)

    held0: List[str] = []
    holds = fn.sf.holds.get(fn.node.lineno)
    if holds is not None:
        hid = _lock_id(fn.sf, fn.cls, holds)
        if _order_index(manifest, hid) is not None:
            held0.append(hid)
    for stmt in fn.node.body:
        walk(stmt, held0)
    return out

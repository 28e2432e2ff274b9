"""Pass 2 — int64-exactness lint on the cycle-count call graph.

The paper's cycle/energy quantities are integers; the repo carries them
in float64 (exact below 2**53) and in int64 device grids.  Within the
manifest's ``exact_scope`` roots — expanded through same-scope calls —
the following introduce values that break bit-exactness:

``EX001``  a bare ``/`` not directly inside a ``ceil``/``floor``/``round``
           call (the sanctioned exact ceil-of-integer-division idiom);
           ``//`` is what integer math wants.
``EX002``  a call to a float-producing reduction (``mean``, ``average``,
           ``true_divide``, ...) from ``exact_banned_calls``.
``EX003``  a non-integral float literal (``0.5`` — ``2.0`` is fine).
``EX004``  any reference to ``float32`` (name, attribute, or dtype
           string) — float32 cannot hold cycle counts past 2**24.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Sequence, Set, Tuple

from .manifest import Manifest
from .report import Finding
from .source import SourceFile, expr_text, scope_name

PASS_ID = "exact"

_DEF = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def _roots(files: Sequence[SourceFile], manifest: Manifest
           ) -> List[Tuple[SourceFile, ast.AST]]:
    out = []
    for suffix, names in manifest.exact_scope.items():
        for sf in files:
            if not sf.matches(suffix):
                continue
            for node in sf.tree.body:
                if isinstance(node, _DEF) and (names == ("*",)
                                               or node.name in names):
                    out.append((sf, node))
    return out


def _expand(roots: List[Tuple[SourceFile, ast.AST]],
            files: Sequence[SourceFile], manifest: Manifest
            ) -> List[Tuple[SourceFile, ast.AST]]:
    """Closure of the roots over calls that resolve to a *unique*
    top-level definition inside the exact-scope fileset."""
    defs: Dict[str, List[Tuple[SourceFile, ast.AST]]] = {}
    for sf in files:
        if not any(sf.matches(s) for s in manifest.exact_scope):
            continue
        for node in sf.tree.body:
            if isinstance(node, _DEF):
                defs.setdefault(node.name, []).append((sf, node))
    seen: Set[int] = {id(n) for _, n in roots}
    work = list(roots)
    queue = list(roots)
    while queue:
        sf, node = queue.pop()
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            name = expr_text(n.func).split(".")[-1]
            cands = defs.get(name, [])
            if len(cands) == 1 and id(cands[0][1]) not in seen:
                seen.add(id(cands[0][1]))
                work.append(cands[0])
                queue.append(cands[0])
    return work


def _div_sanctioned(node: ast.BinOp, manifest: Manifest) -> bool:
    """True iff the division sits (through arithmetic) directly inside a
    ``ceil``/``floor``/``round`` call — the exact-div idiom."""
    n: ast.AST = node
    p = getattr(n, "parent", None)
    while isinstance(p, (ast.BinOp, ast.UnaryOp)):
        n = p
        p = getattr(p, "parent", None)
    if isinstance(p, ast.Call):
        fname = expr_text(p.func).split(".")[-1]
        return fname in manifest.exact_div_wrappers and n in p.args
    return False


def run(files: Sequence[SourceFile], manifest: Manifest) -> List[Finding]:
    findings: List[Finding] = []
    scoped = _expand(_roots(files, manifest), files, manifest)
    checked: Set[int] = set()
    for sf, root in scoped:
        for node in ast.walk(root):
            if id(node) in checked:
                continue
            checked.add(id(node))
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div) \
                    and not _div_sanctioned(node, manifest):
                findings.append(Finding(
                    sf.rel, node.lineno, node.col_offset, PASS_ID, "EX001",
                    "bare '/' in int64-exact scope: use '//' or wrap the "
                    "ceil-div in np.ceil(...)",
                    symbol=f"{scope_name(node)}:/"))
            elif isinstance(node, ast.Call):
                fname = expr_text(node.func).split(".")[-1]
                if fname in manifest.exact_banned_calls:
                    findings.append(Finding(
                        sf.rel, node.lineno, node.col_offset, PASS_ID,
                        "EX002",
                        f"float-producing call {fname!r} in int64-exact "
                        f"scope", symbol=f"{scope_name(node)}:{fname}"))
            elif isinstance(node, ast.Constant):
                if isinstance(node.value, float) \
                        and not node.value.is_integer():
                    findings.append(Finding(
                        sf.rel, node.lineno, node.col_offset, PASS_ID,
                        "EX003",
                        f"non-integral float literal {node.value!r} in "
                        f"int64-exact scope",
                        symbol=f"{scope_name(node)}:{node.value!r}"))
                elif node.value == "float32":
                    findings.append(Finding(
                        sf.rel, node.lineno, node.col_offset, PASS_ID,
                        "EX004",
                        "float32 dtype in int64-exact scope: cannot hold "
                        "cycle counts past 2**24",
                        symbol=f"{scope_name(node)}:float32"))
            elif (isinstance(node, ast.Attribute)
                  and node.attr == "float32") \
                    or (isinstance(node, ast.Name)
                        and node.id == "float32"):
                findings.append(Finding(
                    sf.rel, node.lineno, node.col_offset, PASS_ID, "EX004",
                    "float32 reference in int64-exact scope: cannot hold "
                    "cycle counts past 2**24",
                    symbol=f"{scope_name(node)}:float32"))
    return findings

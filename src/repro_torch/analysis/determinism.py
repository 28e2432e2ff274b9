"""Pass 5 — determinism lint on the pricing paths.

The serving tier dedups identical queries on the promise that the same
query always prices to the same answer, and the persistence layer's
self-check re-derives stored points expecting bit-identical cycles.
Within the manifest's ``determinism_modules``:

``DT001``  wall-clock reads (``time.time``, ``datetime.now``, ...) —
           ``time.monotonic``/``perf_counter`` stay legal (timeouts are
           not priced).
``DT002``  unseeded randomness: ``np.random.default_rng()``/``Random()``
           with no seed, or any call on the global ``random``/
           ``np.random`` state; a torch draw (``torch.rand``, ``randn``,
           ``randint``, ``randperm``, ``normal``, ``bernoulli``,
           ``multinomial``, the ``*_like`` variants) without
           ``generator=``, which draws from torch's global generator; a
           ``torch.Generator(...)`` not seeded in the same expression
           (``.manual_seed(...)``).
``DT003``  iteration over a set (``for``/``list()``/``tuple()``) —
           nondeterministic order under hash randomization; wrap in
           ``sorted(...)``.
``DT004``  builtin ``hash()`` — varies per process under
           ``PYTHONHASHSEED`` randomization.
"""
from __future__ import annotations

import ast
from typing import List, Sequence, Set

from .manifest import Manifest
from .report import Finding
from .source import SourceFile, expr_text, scope_name

PASS_ID = "determinism"


def _is_set_expr(e: ast.AST, setvars: Set[str]) -> bool:
    if isinstance(e, (ast.Set, ast.SetComp)):
        return True
    if isinstance(e, ast.Call) and expr_text(e.func) in ("set", "frozenset"):
        return True
    return isinstance(e, ast.Name) and e.id in setvars


def _local_nodes(scope: ast.AST) -> List[ast.AST]:
    """Nodes of one scope, not descending into nested defs/lambdas
    (their locals are their own; checked in their own scope walk)."""
    out: List[ast.AST] = []
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        out.append(n)
        stack.extend(ast.iter_child_nodes(n))
    return out


def _set_findings(sf: SourceFile, scope: ast.AST) -> List[Finding]:
    local = _local_nodes(scope)
    setvars: Set[str] = set()
    for n in local:
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name) \
                and _is_set_expr(n.value, setvars):
            setvars.add(n.targets[0].id)
    out: List[Finding] = []
    for n in local:
        bad = None
        if isinstance(n, ast.For) and _is_set_expr(n.iter, setvars):
            bad = "iteration over a set"
        elif isinstance(n, ast.Call) \
                and expr_text(n.func) in ("list", "tuple") \
                and n.args and _is_set_expr(n.args[0], setvars):
            bad = f"{expr_text(n.func)}() over a set"
        if bad is not None:
            out.append(Finding(
                sf.rel, n.lineno, n.col_offset, PASS_ID, "DT003",
                f"{bad} has nondeterministic order under hash "
                f"randomization; wrap in sorted(...)",
                symbol=f"{scope_name(n)}:set-iter"))
    return out


def _torch_rng(sf: SourceFile, node: ast.Call, text: str,
               manifest: Manifest) -> List[Finding]:
    """DT002 for torch's global generator and unseeded generators."""
    parts = text.split(".")
    if len(parts) != 2 or parts[0] != "torch":
        return []
    if parts[1] in manifest.torch_rng_calls \
            and not any(k.arg == "generator" for k in node.keywords):
        msg = f"{text}() without generator= draws from torch's global " \
              f"generator in a pricing path"
    elif parts[1] == "Generator" and not (
            isinstance(getattr(node, "parent", None), ast.Attribute)
            and node.parent.attr == "manual_seed"
            and isinstance(getattr(node.parent, "parent", None), ast.Call)):
        msg = "torch.Generator() not seeded in the same expression " \
              "(.manual_seed(...)) in a pricing path"
    else:
        return []
    return [Finding(sf.rel, node.lineno, node.col_offset, PASS_ID, "DT002",
                    msg, symbol=f"{scope_name(node)}:{text}")]


def run(files: Sequence[SourceFile], manifest: Manifest) -> List[Finding]:
    findings: List[Finding] = []
    for sf in files:
        if not any(sf.matches(m) for m in manifest.determinism_modules):
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            text = expr_text(node.func)
            if text in manifest.banned_clock_calls:
                findings.append(Finding(
                    sf.rel, node.lineno, node.col_offset, PASS_ID, "DT001",
                    f"wall-clock read {text}() in a pricing path",
                    symbol=f"{scope_name(node)}:{text}"))
                continue
            torch_rng = _torch_rng(sf, node, text, manifest)
            if torch_rng:
                findings.extend(torch_rng)
                continue
            if text == "hash":
                findings.append(Finding(
                    sf.rel, node.lineno, node.col_offset, PASS_ID, "DT004",
                    "builtin hash() varies per process under "
                    "PYTHONHASHSEED randomization",
                    symbol=f"{scope_name(node)}:hash"))
                continue
            for root in manifest.banned_rng_roots:
                # pure dotted chains only: a call in the middle
                # ("random.Random(seed).random") is an instance method
                # on a seeded RNG, not the module-global state
                if "(" in text or not text.startswith(root + "."):
                    continue
                last = text.rsplit(".", 1)[-1]
                if last in manifest.seeded_rng_ctors:
                    if not node.args and not node.keywords:
                        findings.append(Finding(
                            sf.rel, node.lineno, node.col_offset, PASS_ID,
                            "DT002",
                            f"unseeded RNG constructor {text}() in a "
                            f"pricing path", symbol=f"{scope_name(node)}:"
                                                    f"{text}"))
                else:
                    findings.append(Finding(
                        sf.rel, node.lineno, node.col_offset, PASS_ID,
                        "DT002",
                        f"call on the global (unseeded) RNG state: {text}",
                        symbol=f"{scope_name(node)}:{text}"))
                break
        findings.extend(_set_findings(sf, sf.tree))
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                findings.extend(_set_findings(sf, node))
    return findings

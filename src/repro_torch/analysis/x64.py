"""Pass 3 — int64 width check on the grid modules.

The JAX package guards ``enable_x64`` because JAX's default integer is
int32.  Torch has no such mode; its hazards are others.  Its default
float is float32, so a factory left to its defaults, or an int64 tensor
scaled or compared by a Python float, lands in float32, where training
cycles near 1.7e10 are no longer exact; and the ``ctypes`` interface of
the grid kernel narrows whatever it declares narrower than 64 bits.
Within the manifest's ``x64_modules``:

``X64001``  a torch tensor factory (``torch.tensor``, ``full``,
            ``zeros``, ...) without an explicit ``dtype=``.
``X64002``  a dtype or cast narrower than 64 bits: ``torch.int32``,
            ``torch.float``, ``np.float32``, ...; ``.int()``,
            ``.float()``, ...; a ``ctypes.c_int``-like type in a
            ``_fields_`` or ``argtypes`` declaration.  Values narrow by
            nature (a launch plan's block count, a device index, an
            error code) are waived on their line with
            ``# analysis: allow[X64002]`` and a reason.

And in every scanned file:

``X64003``  ``torch.set_default_dtype``/``set_default_tensor_type``:
            it changes what every factory above makes.
"""
from __future__ import annotations

import ast
from typing import List, Sequence

from .manifest import Manifest
from .report import Finding
from .source import SourceFile, expr_text, scope_name

PASS_ID = "x64"

# roots whose attributes are dtypes, not tensors to cast
_NUMERIC_ROOTS = ("torch", "np", "numpy")


def _finding(sf: SourceFile, node: ast.AST, code: str, msg: str,
             what: str) -> Finding:
    return Finding(sf.rel, node.lineno, node.col_offset, PASS_ID, code, msg,
                   symbol=f"{scope_name(node)}:{what}")


def _declares_ctypes(node: ast.AST) -> bool:
    """True iff ``node`` sits in the value of an assignment to
    ``_fields_`` or ``<lib>.<fn>.argtypes``."""
    n = getattr(node, "parent", None)
    while n is not None and not isinstance(n, ast.stmt):
        n = getattr(n, "parent", None)
    if not isinstance(n, (ast.Assign, ast.AnnAssign)):
        return False
    targets = n.targets if isinstance(n, ast.Assign) else [n.target]
    return any((isinstance(t, ast.Name) and t.id == "_fields_")
               or (isinstance(t, ast.Attribute) and t.attr in ("_fields_",
                                                               "argtypes"))
               for t in targets)


def _narrowing(sf: SourceFile, manifest: Manifest) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call):
            text = expr_text(node.func)
            parts = text.split(".")
            if parts[0] == "torch" and len(parts) == 2 \
                    and parts[1] in manifest.x64_factories \
                    and not any(k.arg == "dtype" for k in node.keywords):
                out.append(_finding(
                    sf, node, "X64001",
                    f"{text}() without dtype=: its dtype comes from "
                    f"torch's defaults (float32 for Python floats)", text))
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in manifest.x64_narrow_casts \
                    and parts[0] not in _NUMERIC_ROOTS:
                out.append(_finding(
                    sf, node, "X64002",
                    f"cast .{node.func.attr}() narrows to fewer than 64 "
                    f"bits", f".{node.func.attr}()"))
        elif isinstance(node, ast.Attribute):
            text = expr_text(node)
            if text in manifest.x64_narrow_dtypes:
                out.append(_finding(
                    sf, node, "X64002",
                    f"dtype {text} is narrower than 64 bits", text))
            elif node.attr in manifest.x64_narrow_ctypes \
                    and _declares_ctypes(node):
                out.append(_finding(
                    sf, node, "X64002",
                    f"ctypes declaration {text} is narrower than 64 bits",
                    text))
        elif isinstance(node, ast.Name) \
                and node.id in manifest.x64_narrow_ctypes \
                and _declares_ctypes(node):
            out.append(_finding(
                sf, node, "X64002",
                f"ctypes declaration {node.id} is narrower than 64 bits",
                node.id))
    return out


def run(files: Sequence[SourceFile], manifest: Manifest) -> List[Finding]:
    findings: List[Finding] = []
    for sf in files:
        if any(sf.matches(m) for m in manifest.x64_modules):
            findings.extend(_narrowing(sf, manifest))
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call):
                text = expr_text(node.func)
                if text.split(".")[-1] in manifest.x64_default_setters:
                    findings.append(_finding(
                        sf, node, "X64003",
                        f"{text}() changes the dtype of every later torch "
                        f"factory", text))
    return findings

"""Pass 4 — fault-point consistency.

``core.faultinject`` identifies fault points by bare strings; a typo at
an injection site (or in a test's ``arm(...)``/``REPRO_FAULTS`` spec)
silently disables the fault — the recovery test then passes by testing
nothing.  This pass cross-checks three sets of names:

``FP000``  the registry (``FAULT_POINTS``) is missing from the fault
           module entirely.
``FP001``  a string point passed to ``fire``/``arm``/``armed``/
           ``fired``/``disarm`` (in src *or* tests) is not registered.
``FP002``  a registered point is never ``fire``d anywhere in src — dead
           registry entry or missing injection site.
``FP003``  a registered point never appears in any test (string scan,
           splitting ``REPRO_FAULTS``-style ``a:2,b`` specs) — the
           recovery path is never exercised.  Skipped when the analyzed
           fileset contains no tests directory.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .manifest import Manifest
from .report import Finding
from .source import SourceFile, expr_text

PASS_ID = "faults"


def _fault_aliases(sf: SourceFile, manifest: Manifest
                   ) -> Tuple[Dict[str, str], Set[str]]:
    """(direct imports name->orig fn, module aliases)."""
    direct: Dict[str, str] = {}
    mods: Set[str] = set()
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                if a.name == "faultinject":      # from . import faultinject
                    mods.add(a.asname or a.name)
                elif node.module and node.module.endswith("faultinject"):
                    direct[a.asname or a.name] = a.name
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.endswith("faultinject"):
                    mods.add(a.asname or a.name.rsplit(".", 1)[-1])
    return direct, mods


def _fault_call(node: ast.Call, direct: Dict[str, str], mods: Set[str],
                manifest: Manifest) -> Optional[str]:
    text = expr_text(node.func)
    parts = text.split(".")
    if len(parts) == 1:
        orig = direct.get(parts[0])
        if orig in manifest.fault_call_names:
            return orig
    elif len(parts) >= 2 and parts[-2] in mods \
            and parts[-1] in manifest.fault_call_names:
        return parts[-1]
    return None


def run(files: Sequence[SourceFile], manifest: Manifest) -> List[Finding]:
    findings: List[Finding] = []
    fault_sf = next((sf for sf in files
                     if sf.matches(manifest.fault_module)), None)
    if fault_sf is None:
        return findings

    registry: Dict[str, int] = {}
    found = False
    for node in fault_sf.tree.body:
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target] if isinstance(node, ast.AnnAssign) else []
        if any(isinstance(t, ast.Name)
               and t.id == manifest.fault_registry_name
               for t in targets) \
                and isinstance(node.value, ast.Dict):
            found = True
            for k in node.value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    registry[k.value] = k.lineno
    if not found:
        findings.append(Finding(
            fault_sf.rel, 1, 0, PASS_ID, "FP000",
            f"fault registry {manifest.fault_registry_name!r} not found "
            f"in the fault module",
            symbol=manifest.fault_registry_name))
        return findings

    def is_test(sf: SourceFile) -> bool:
        return f"/{manifest.tests_dir_name}/" in f"/{sf.rel}"

    fired_in_src: Set[str] = set()
    for sf in files:
        if sf is fault_sf:
            continue
        direct, mods = _fault_aliases(sf, manifest)
        if not direct and not mods:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            fname = _fault_call(node, direct, mods, manifest)
            if fname is None or not node.args:
                continue
            arg = node.args[0]
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                continue
            point = arg.value
            if fname == "fire" and not is_test(sf):
                fired_in_src.add(point)
            if point not in registry:
                findings.append(Finding(
                    sf.rel, node.lineno, node.col_offset, PASS_ID, "FP001",
                    f"unknown fault point {point!r} passed to {fname}() — "
                    f"not in {manifest.fault_registry_name}",
                    symbol=point))

    for point, line in sorted(registry.items()):
        if point not in fired_in_src:
            findings.append(Finding(
                fault_sf.rel, line, 0, PASS_ID, "FP002",
                f"registered fault point {point!r} is never fired from "
                f"src — dead entry or missing injection site",
                symbol=point))

    test_files = [sf for sf in files if is_test(sf)]
    if test_files:
        covered: Set[str] = set()
        for sf in test_files:
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Constant) \
                        and isinstance(node.value, str):
                    for tok in re.split(r"[,:]", node.value):
                        covered.add(tok.strip())
        for point, line in sorted(registry.items()):
            if point not in covered:
                findings.append(Finding(
                    fault_sf.rel, line, 0, PASS_ID, "FP003",
                    f"registered fault point {point!r} is never armed in "
                    f"any test — recovery path unexercised",
                    symbol=point))
    return findings

"""No file of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the port: top-level module names compared
whole (``repro_torch`` is not ``repro``)."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in top_level_imports(path)
    assert "repro_torch" not in path.read_text()


def test_the_scan_sees_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.kernels\nfrom repro.core import x\n"
                 "import importlib\nimportlib.import_module('jax.numpy')\n")
    assert top_level_imports(f) == {"repro_torch", "repro", "importlib",
                                    "jax"}

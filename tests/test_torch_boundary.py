"""The port's package boundary: ``repro_torch`` imports neither jax nor the
JAX package ``repro``, and ``chip_smoke.py`` neither.

Checked twice: by importing every module of the port in a fresh process
where ``import jax`` fails, and by an AST scan of every source file for
import statements naming ``jax`` or ``repro``.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "repro")


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_port_has_the_slice_modules():
    mods = set(_port_modules())
    for name in ("hardware", "layers", "networks", "backward", "conv_model",
                 "simd_model", "gemm_model", "tiling", "energy",
                 "objectives", "faultinject", "store", "dse", "study",
                 "gridtorch"):
        assert f"repro_torch.core.{name}" in mods
    assert "repro_torch.kernels.reduce" in mods
    assert (PORT / "kernels" / "csrc" / "grid_minmax.cu").is_file()


def test_port_has_the_kernel_entry_point_modules():
    mods = set(_port_modules())
    assert {"repro_torch.interop", "repro_torch.core.gpu_model"} <= mods
    for name in ("ref", "matmul", "fused_addnorm", "bn", "flash_attention",
                 "ops", "forward", "_dispatch", "_ext"):
        assert f"repro_torch.kernels.{name}" in mods
    for source in ("matmul.cu", "fused_addnorm.cu", "bn_forward.cu",
                   "flash_attention.cu", "common.cuh"):
        assert (PORT / "kernels" / "csrc" / source).is_file()


def test_every_port_module_imports_without_jax_or_repro():
    script = (
        "import importlib, json, sys\n"
        "sys.modules['jax'] = None\n"
        f"mods = {_port_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or\n"
        "    m.startswith(('jax.', 'jaxlib')) or m == 'repro' or\n"
        "    m.startswith('repro.'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    # 'jax' itself is the None placeholder this script planted
    assert [m for m in loaded if m != "jax"] == []


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_file_imports_jax_or_repro(path):
    bad = [(line, root) for line, root in _imported_roots(path)
           if root in FORBIDDEN]
    assert bad == [], f"{path}: imports {bad}"


def test_relative_imports_stay_inside_the_port():
    """A relative import may not climb out of ``repro_torch`` (into
    ``src`` and from there into ``repro``)."""
    for path in PORT.rglob("*.py"):
        depth = len(path.relative_to(PORT).parts) - 1
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level <= depth + 1, f"{path}:{node.lineno}"


def test_jax_reference_shim_leaves_no_trace():
    """What the parity tests' ``jax_grid`` fixture runs, driven by hand:
    afterwards the JAX package's grid modules are gone from
    ``sys.modules`` and from their packages, and (on a jax that lacks
    ``jax.experimental.enable_x64``) ``import repro.core.gridax`` fails
    again exactly as it does without the shim."""
    import jax.experimental
    from _jax_reference import MODULES, jax_reference
    native = hasattr(jax.experimental, "enable_x64")
    preloaded = [m for m in MODULES if m in sys.modules]
    with pytest.MonkeyPatch.context() as mp, \
            jax_reference(mp) as (gridax, jreduce):
        assert gridax.__name__ == "repro.core.gridax"
        assert hasattr(jreduce, "grid_minmax_pallas")
    assert hasattr(jax.experimental, "enable_x64") == native
    for name in MODULES:
        assert (name in sys.modules) == (name in preloaded)
    if native:
        pytest.skip("this jax still has jax.experimental.enable_x64")
    import repro.core
    assert not hasattr(repro.core, "gridax")
    with pytest.raises(ImportError):
        import repro.core.gridax  # noqa: F401
    assert "repro.core.gridax" not in sys.modules
    assert "repro.kernels.reduce" not in sys.modules

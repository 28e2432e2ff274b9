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


def test_port_has_the_training_slice_modules():
    mods = set(_port_modules())
    assert {"repro_torch.core.simulator", "repro_torch.optim",
            "repro_torch.optim.optimizers",
            "repro_torch.kernels.training"} <= mods
    assert (PORT / "kernels" / "csrc" / "bn_backward.cu").is_file()


def test_port_has_the_front_end_and_service_modules():
    mods = set(_port_modules())
    assert {"repro_torch.configs", "repro_torch.models.common",
            "repro_torch.models.frontends", "repro_torch.core.optimize",
            "repro_torch.serve", "repro_torch.serve.service",
            "repro_torch.serve.client", "repro_torch.serve.metrics"} <= mods
    for arch in ("qwen3_0_6b", "gemma3_27b", "whisper_tiny", "pixtral_12b",
                 "mamba2_130m", "llama4_maverick", "granite_moe_1b",
                 "recurrentgemma_9b", "smollm_360m", "stablelm_1_6b"):
        assert f"repro_torch.configs.{arch}" in mods


def test_port_has_the_model_stack_modules():
    mods = set(_port_modules())
    assert {"repro_torch.models.layers", "repro_torch.models.attention",
            "repro_torch.models.transformer", "repro_torch.launch",
            "repro_torch.launch.serve"} <= mods


def test_port_has_the_mixer_modules():
    mods = set(_port_modules())
    assert {"repro_torch.models.moe", "repro_torch.models.ssm",
            "repro_torch.models.rglru"} <= mods


def test_port_has_the_training_path_modules():
    mods = set(_port_modules())
    assert {"repro_torch.data", "repro_torch.data.pipeline",
            "repro_torch.distributed", "repro_torch.distributed.fault",
            "repro_torch.checkpoint", "repro_torch.checkpoint.manager",
            "repro_torch.launch.train"} <= mods


def test_port_has_the_parallelism_modules():
    """The compression, mesh, shapes and pipeline modules, each reached
    by the scans below."""
    mods = set(_port_modules())
    scanned = set(PORT.rglob("*.py"))
    for name in ("optim/compression", "launch/mesh", "launch/shapes",
                 "distributed/pipeline"):
        assert f"repro_torch.{name.replace('/', '.')}" in mods
        assert PORT / f"{name}.py" in scanned


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
            yield from (f"{node.module}.{alias.name}" for alias in node.names)


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_only_tests_import_torch_testing_internals(path):
    """``torch.testing._internal`` (the ``fake`` process group's store
    among it) is test code: the port and the smoke run never import
    it."""
    bad = [m for m in _imported_modules(path)
           if m.startswith("torch.testing._internal")]
    assert bad == [], f"{path}: imports {bad}"


def test_every_port_module_imports_without_jax_or_repro():
    script = (
        "import importlib, json, sys\n"
        "sys.modules['jax'] = None\n"
        f"mods = {_port_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        # what runs only when called: the LLM lowering, refine, a service
        "from repro_torch import configs\n"
        "from repro_torch.core import INFER_PRESETS, Study, Workload\n"
        "from repro_torch.serve import DSEClient, DSEService\n"
        "for arch in configs.ARCHS:\n"
        "    assert Workload(arch, training=True).layers()\n"
        "study = Study(INFER_PRESETS[16], sizes=(32, 64, 128, 256),\n"
        "              bws=(8, 16, 32, 64), device='cpu')\n"
        "wl = Workload('qwen3_0_6b', seq=16)\n"
        "assert study.search(wl, 512, 64, method='refine').refine\n"
        "with DSEService(study) as svc:\n"
        "    DSEClient(svc).query(wl, 512, 64)\n"
        # the model stack: a reduced Qwen3 served on the CPU
        "from repro_torch.launch.serve import serve_loop\n"
        "for arch in ('qwen3-0.6b', 'mamba2-130m', 'recurrentgemma-9b',\n"
        "             'granite-moe-1b-a400m'):\n"
        "    serve_loop(arch, batch=1, prompt_len=3, gen=2,\n"
        "               device='cpu', log=lambda msg: None)\n"
        # the training path: two steps with a checkpoint, then a resume
        "import tempfile\n"
        "from repro_torch.launch.train import train_loop\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    for stop in (1, None):\n"
        "        train_loop('smollm-360m', steps=2, batch=1, seq=8,\n"
        "                   ckpt_dir=d, stop_after=stop, device='cpu',\n"
        "                   log=lambda msg: None)\n"
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
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    + sorted((ROOT / "scripts").glob("*.py")),
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

"""The port's examples (``examples/torch_*.py``) run as a user runs them,
on the CPU (``--device cpu``), each in a process where ``jax`` and the
JAX package cannot be imported.

Each exits 0; the two DSE examples print the lines of their JAX twins
(``examples/simulate_accelerator.py``, ``examples/dse_service.py``, which
import only the JAX package's jax-free ``core`` and ``serve``), apart
from the service's ``summary()`` line, which prints latencies; and
without ``--device`` on a machine with no visible card each raises, as
``serve_loop`` does, rather than falling back to the CPU.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "serve_batched", "train_resume",
            "simulate_accelerator", "dse_service")
TWINS = ("simulate_accelerator", "dse_service")
# lines that print times or latencies
TIMED = re.compile(r"\bp50=|\bp95=")
BLOCK_JAX = ("import runpy, sys\n"
             "sys.modules['jax'] = None\n"
             "sys.modules['repro'] = None\n"
             "sys.argv = sys.argv[1:]\n"
             "runpy.run_path(sys.argv[0], run_name='__main__')\n")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)
    env.pop("REPRO_DSE_BACKEND", None)
    return env


def _run(args, timeout=300, **extra):
    return subprocess.run(args, cwd=ROOT, env=_env(**extra),
                          capture_output=True, text=True, timeout=timeout)


_OUT = {}


def _port_run(name):
    """The port example's run on the CPU, once a process."""
    if name not in _OUT:
        _OUT[name] = _run([sys.executable, "-c", BLOCK_JAX,
                           str(ROOT / "examples" / f"torch_{name}.py"),
                           "--device", "cpu"])
    return _OUT[name]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu_without_jax(name):
    proc = _port_run(name)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert proc.stdout.count("== ") >= 2


def test_train_resume_holds_its_drift():
    out = _port_run("train_resume").stdout
    assert "OK — resumed trajectory matches" in out
    drift = float(re.search(r"drift vs uninterrupted run: (\S+)",
                            out).group(1))
    assert drift < 1e-3


@pytest.mark.parametrize("name", TWINS)
def test_example_prints_the_jax_examples_lines(name):
    port = _port_run(name)
    jax = _run([sys.executable, str(ROOT / "examples" / f"{name}.py")])
    assert port.returncode == 0 and jax.returncode == 0, jax.stderr[-4000:]

    def lines(text):
        return [ln for ln in text.splitlines() if not TIMED.search(ln)]
    assert lines(port.stdout) == lines(jax.stdout)
    assert len(lines(port.stdout)) >= 10
    assert len(port.stdout.splitlines()) - len(lines(port.stdout)) \
        == (1 if name == "dse_service" else 0)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_a_card_raises(name):
    proc = _run([sys.executable, str(ROOT / "examples" / f"torch_{name}.py")],
                CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert "RuntimeError" in proc.stderr and "cpu" in proc.stderr

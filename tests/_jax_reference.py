"""The JAX package's grid reductions, loaded for the port's parity tests.

``repro.core.gridax`` and ``repro.kernels.reduce`` import
``jax.experimental.enable_x64``, a name that newer jax keeps only as
``jax.enable_x64``.  The ``jax_grid`` fixture aliases it through
``monkeypatch`` for one test, imports the two modules, and on teardown
removes every trace: the modules leave ``sys.modules`` and their parent
packages, and the alias is undone, so the next ``import
repro.core.gridax`` in the process behaves exactly as it did before.
"""
import contextlib
import importlib
import sys

import jax
import jax.experimental
import pytest

MODULES = ("repro.core.gridax", "repro.kernels.reduce")


@contextlib.contextmanager
def jax_reference(monkeypatch):
    """``(gridax, reduce)`` of the JAX package inside the block; the alias
    goes through ``monkeypatch``, and on exit the modules this block
    imported leave ``sys.modules`` and their parent packages."""
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                            raising=False)
    fresh = [m for m in MODULES if m not in sys.modules]
    try:
        yield tuple(importlib.import_module(m) for m in MODULES)
    finally:
        for name in fresh:
            sys.modules.pop(name, None)
            parent, _, attr = name.rpartition(".")
            if hasattr(sys.modules.get(parent), attr):
                delattr(sys.modules[parent], attr)


@pytest.fixture
def jax_grid(monkeypatch):
    """``(gridax, reduce)`` of the JAX package, valid for one test."""
    with jax_reference(monkeypatch) as mods:
        yield mods

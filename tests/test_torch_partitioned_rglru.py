"""The partitioned RG-LRU block (``models/rglru.py`` on ``DTensor``s: x and
the gate split on ``rnn``, the conv on the local channels with its cache
whole on ``model``, r's and i's row-parallel float32 products
reduce-scattered onto ``rnn``, the scan on the local channels) and
recurrentgemma-9b's local attention beside it, against the port's
unpartitioned route and the JAX package's ``jax.jit(in_shardings=...)``
steps, on the CPU.

The harness of ``tests/test_torch_partitioned.py`` (``run_cases``): four
``gloo`` ranks, float32, ``PROD_RULES`` sized to the mesh, the same
numpy weights and tokens (4 x 12) through both routes of the port and,
in a subprocess with 4 forced host devices, the reference's jitted
sharded steps.  The cases, on reduced recurrentgemma-9b (7 layers: two
(rglru, rglru, attn) groups and a remainder RG-LRU layer; rnn 64; 4
query heads and the one KV head, read whole on every rank; window 8, so
that the decode steps at positions 12 and 13 attend windows):

* ``recurrentgemma``: a (2, 2) mesh, rnn split 32/32 on ``model``;
* ``recurrentgemma_save_mixer``: remat ``save_mixer`` (each mixer's
  output kept, ``models/remat.py``'s tape reading a ``DTensor``);
* ``recurrentgemma_straddle``: a (4, 1) mesh, one row of the batch a
  rank and everything whole on ``model``.

Held in ``tests/test_torch_partitioned.py``'s ``LIMITS``, the gradients
and the step's moments at ``tests/test_torch_train.py``'s limit for
recurrentgemma (``GRAD_REL``, 3e-4), as
``tests/test_torch_partitioned_moe.py::_limits`` takes them.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_partitioned import (LIMITS, hold_jax,  # noqa: E402
                                    hold_unpartitioned, run_cases)
from test_torch_train import GRAD_REL  # noqa: E402

RG = "recurrentgemma-9b"
CASES = {
    "recurrentgemma": (RG, {}),
    "recurrentgemma_save_mixer": (RG, {"remat": True,
                                       "remat_policy": "save_mixer"}),
    "recurrentgemma_straddle": (RG, {"mesh": (4, 1)}),
}


def _limits():
    grads = GRAD_REL[RG]
    return {**LIMITS, "grads": grads, "m": max(LIMITS["m"], grads),
            "v": max(LIMITS["v"], 2 * grads)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("partitioned_rglru")
    return tmp, run_cases(tmp, CASES, timeout=300)


@pytest.mark.parametrize("name", CASES)
def test_partitioned_rglru_equals_unpartitioned(runs, name):
    _, ranks = runs
    hold_unpartitioned(ranks, name, _limits())
    assert ("prefill" in ranks[0][name]["err"]) == (
        name != "recurrentgemma_save_mixer")


@pytest.mark.parametrize("name", CASES)
def test_partitioned_rglru_equals_the_jax_sharded_step(runs, name):
    tmp, _ = runs
    hold_jax(tmp, name, _limits())


def test_the_reduced_config_runs_a_remainder_and_windows():
    """7 layers (a remainder RG-LRU layer after two groups), rnn 64 over
    2, one KV head, and a window shorter than the decode positions."""
    from repro_torch.configs import get_config, reduced
    from test_torch_partitioned import DECODE, SEQ
    cfg = reduced(get_config(RG))
    assert cfg.n_layers == 7 and cfg.n_layers % len(cfg.pattern) == 1
    assert cfg.rnn_width == 64 and cfg.n_kv_heads == 1
    assert cfg.window == 8 < SEQ + DECODE - 1

"""The partitioned MoE layer (``models/moe.py`` on ``DTensor``s: the
experts on ``data``, ``expert_ff`` on ``model``, the dispatch an explicit
all-to-all over ``data``) against the port's unpartitioned route and the
JAX package's ``jax.jit(in_shardings=...)`` steps, on the CPU.

The harness of ``tests/test_torch_partitioned.py`` (``run_cases``): four
``gloo`` ranks on a (2, 2) ``("data", "model")`` mesh, float32,
``PROD_RULES`` sized to it, the same numpy weights and tokens (4 x 12)
through both routes of the port and, in a subprocess with 4 forced host
devices, the reference's jitted sharded steps.  The cases, on reduced
granite-moe-1b (8 experts, top-2, every layer MoE) and reduced
llama4-maverick (8 experts, top-1, a shared expert, MoE on every second
layer):

* ``blocks``: ``moe_block`` 8, so each data rank holds whole blocks (3
  of its 24 tokens) and the experts' rows cross by all-to-all;
* ``spanning``: the default block (64: one block of all 48 tokens over
  both data ranks), the decode shape of ``decode_32k`` (every decode
  step here spans too: 4 tokens, one block);
* ``dropped``: capacities that must drop choices (``test_the_dropped
  _cases_drop``): granite with whole blocks of 24, llama4 with the
  spanning block;
* ``scatter``: ``moe_dispatch="scatter"`` (granite spanning with drops,
  llama4 with whole blocks);
* ``remat``: granite under remat ``full`` (loss, gradients, the step);
* ``straddle``: granite on a (4, 1) mesh with blocks of 24 (two ranks a
  block, two blocks among the four experts' ranks);
* ``pods``: granite on a (2, 2, 1) ``("pod", "data", "model")`` mesh
  under the multi-pod rules (the batch over ``pod`` x ``data``, the
  experts on ``data`` alone): the default block spans all four batch
  ranks, across both experts' groups.

This file runs granite's cases; llama4's run in
``tests/test_torch_partitioned_llama4.py``.

Held, against both references, each gathered with ``full_tensor``, in
``tests/test_torch_partitioned.py``'s ``LIMITS``: the prefill's and two
decode steps' logits, against the port's unpartitioned route also the
serve step's tokens (equal) and cache, ``Model.loss`` with its aux term,
every gradient and one AdamW step.  llama4's gradients are held at 5e-3,
``tests/test_torch_train.py``'s limit for it (its worst leaf moves by up
to 4.3e-3 under 1e-7 weight noise in the JAX model itself), and the
step's moments, proportional to the gradient and to its square, at 5e-3
and 1e-2.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_partitioned import (LIMITS, hold_jax,  # noqa: E402
                                    hold_unpartitioned, run_cases)
from test_torch_train import GRAD_REL  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.moe import _capacity  # noqa: E402

GRANITE, LLAMA4 = "granite-moe-1b-a400m", "llama4-maverick-400b-a17b"
GRANITE_CASES = {
    "granite_blocks": (GRANITE, {"moe_block": 8}),
    "granite_spanning": (GRANITE, {}),
    "granite_dropped": (GRANITE, {"moe_block": 24, "moe_capacity": 0.5}),
    "granite_scatter": (GRANITE, {"moe_dispatch": "scatter",
                                  "moe_capacity": 0.5}),
    "granite_remat": (GRANITE, {"moe_block": 8, "remat": True,
                                "remat_policy": "full"}),
    "granite_straddle": (GRANITE, {"mesh": (4, 1), "moe_block": 24}),
    "granite_pods": (GRANITE, {"mesh": (2, 2, 1)}),
}
# run by tests/test_torch_partitioned_llama4.py, a file of their own so
# that parallel workers take the two runs apart
LLAMA4_CASES = {
    "llama4_blocks": (LLAMA4, {"moe_block": 8}),
    "llama4_spanning": (LLAMA4, {}),
    "llama4_dropped": (LLAMA4, {"moe_capacity": 0.25}),
    "llama4_scatter": (LLAMA4, {"moe_block": 8, "moe_dispatch": "scatter"}),
}
CASES = {**GRANITE_CASES, **LLAMA4_CASES}
TOKENS = 4 * 12          # test_torch_partitioned's BATCH x SEQ


def _limits(name):
    """``LIMITS``, with a config's own gradient limit where
    ``tests/test_torch_train.py`` has one; one AdamW step's first moment
    is ``(1 - b1) g`` and its second ``(1 - b2) g^2``, so they take the
    gradients' limit and twice it where that is above ``LIMITS``'."""
    grads = GRAD_REL.get(CASES[name][0], LIMITS["grads"])
    return {**LIMITS, "grads": grads, "m": max(LIMITS["m"], grads),
            "v": max(LIMITS["v"], 2 * grads)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("partitioned_moe")
    return tmp, run_cases(tmp, GRANITE_CASES, timeout=600)


@pytest.mark.parametrize("name", GRANITE_CASES)
def test_partitioned_moe_equals_unpartitioned(runs, name):
    _, ranks = runs
    hold_unpartitioned(ranks, name, _limits(name))
    assert ("prefill" in ranks[0][name]["err"]) == (name != "granite_remat")


@pytest.mark.parametrize("name", GRANITE_CASES)
def test_partitioned_moe_equals_the_jax_sharded_step(runs, name):
    tmp, _ = runs
    hold_jax(tmp, name, _limits(name))


@pytest.mark.parametrize("name", [n for n in CASES if "dropped" in n
                                  or "scatter" in n])
def test_the_dropped_cases_drop(name):
    """Each block of a prefill holds more choices than its experts'
    slots, so some are dropped whatever the router chooses."""
    arch, kw = CASES[name]
    cfg = reduced(get_config(arch)).replace(**{k: v for k, v in kw.items()
                                               if k != "mesh"})
    blk = min(cfg.moe_block, TOKENS)
    drops = blk * cfg.top_k > cfg.n_experts * _capacity(cfg)
    assert drops == (name != "llama4_scatter")

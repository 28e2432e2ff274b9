"""The partitioned MoE layer on reduced llama4-maverick (8 experts,
top-1, a shared expert, MoE on every second layer) over four ``gloo``
ranks against the port's unpartitioned route and the JAX package's
jitted sharded steps: ``tests/test_torch_partitioned_moe.py``'s harness
and limits on its ``LLAMA4_CASES`` (whole blocks, the spanning block
with dropped choices, the scatter dispatch), in a file of their own so
that parallel workers run them beside granite's.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_partitioned import (hold_jax, hold_unpartitioned,  # noqa: E402
                                    run_cases)
from test_torch_partitioned_moe import LLAMA4_CASES, _limits  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("partitioned_llama4")
    return tmp, run_cases(tmp, LLAMA4_CASES, timeout=600)


@pytest.mark.parametrize("name", LLAMA4_CASES)
def test_partitioned_moe_equals_unpartitioned(runs, name):
    _, ranks = runs
    hold_unpartitioned(ranks, name, _limits(name))
    assert "prefill" in ranks[0][name]["err"]


@pytest.mark.parametrize("name", LLAMA4_CASES)
def test_partitioned_moe_equals_the_jax_sharded_step(runs, name):
    tmp, _ = runs
    hold_jax(tmp, name, _limits(name))

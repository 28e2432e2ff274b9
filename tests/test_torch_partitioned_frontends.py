"""The partitioned route of the two front-end configs -- whisper-tiny's
encoder, cross-attention and learned positions, pixtral-12b's patch
prefix -- against the port's unpartitioned route and the JAX package's
``jax.jit(in_shardings=...)`` steps, on the CPU.

The harness of ``tests/test_torch_partitioned.py`` (``run_cases``): four
``gloo`` ranks, float32, ``PROD_RULES`` sized to the mesh, the same
numpy weights, tokens (4 x 12) and front-end inputs (seeded, std 0.02:
whisper's 24 frames, pixtral's 8 patches) through both routes of the
port and, in a subprocess with 4 forced host devices, the reference's
jitted sharded steps; each case's cache holds its patch prefix too
(``max_len``).  The cases:

* ``whisper``: reduced whisper-tiny (2 encoder and 2 decoder layers,
  LayerNorm, MHA of 4 heads) on a (2, 2) mesh, its heads split 2/2 on
  ``model``: the encoder's non-causal flash attention, the decoder's
  cross-attention against the encoder (the loss) and against the
  cache's K/V (prefill, decode), the learned positions at the cache's
  offset;
* ``whisper_straddle``: a (4, 1) mesh, one row of the batch a rank and
  every head whole;
* ``whisper_remat``: under remat ``full`` (the encoder's layers
  checkpointed one by one, the decoder's groups);
* ``pixtral``: reduced pixtral-12b (4 query heads and the one KV head)
  on a (2, 2) mesh, the patches ahead of the prompt;
* ``pixtral_straddle``: a (4, 1) mesh, its one KV head split over a
  one-rank ``model`` (``attention._flat``).

Held in ``tests/test_torch_partitioned.py``'s ``LIMITS``, the gradients
and the step's moments at ``tests/test_torch_train.py``'s limits for
these configs (``GRAD_REL``), as
``tests/test_torch_partitioned_moe.py::_limits`` takes them.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_partitioned import (LIMITS, MAX_LEN, hold_jax,  # noqa: E402
                                    hold_unpartitioned, run_cases)
from test_torch_train import GRAD_REL  # noqa: E402

WHISPER, PIXTRAL = "whisper-tiny", "pixtral-12b"
CASES = {
    "whisper": (WHISPER, {}),
    "whisper_straddle": (WHISPER, {"mesh": (4, 1)}),
    "whisper_remat": (WHISPER, {"remat": True, "remat_policy": "full"}),
    "pixtral": (PIXTRAL, {}),
    "pixtral_straddle": (PIXTRAL, {"mesh": (4, 1)}),
}


def _limits(name):
    grads = GRAD_REL[CASES[name][0]]
    return {**LIMITS, "grads": grads, "m": max(LIMITS["m"], grads),
            "v": max(LIMITS["v"], 2 * grads)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("partitioned_frontends")
    return tmp, run_cases(tmp, CASES, timeout=400)


@pytest.mark.parametrize("name", CASES)
def test_partitioned_frontends_equal_unpartitioned(runs, name):
    _, ranks = runs
    hold_unpartitioned(ranks, name, _limits(name))
    assert ("prefill" in ranks[0][name]["err"]) == (name != "whisper_remat")


@pytest.mark.parametrize("name", CASES)
def test_partitioned_frontends_equal_the_jax_sharded_step(runs, name):
    tmp, _ = runs
    hold_jax(tmp, name, _limits(name))


def test_the_reduced_configs_need_room_for_the_patches():
    """The harness's shared ``MAX_LEN`` leaves reduced pixtral's 8
    patches no room beside the 12-token prompt and 2 decode steps; each
    case's cache adds its patches.  whisper's heads split on a 2-rank
    ``model`` and its learned positions reach past the prompt."""
    from repro_torch.configs import get_config, reduced
    from test_torch_partitioned import DECODE, SEQ
    pix, wsp = (reduced(get_config(a)) for a in (PIXTRAL, WHISPER))
    assert SEQ + DECODE <= MAX_LEN < pix.n_patches + SEQ + DECODE
    assert pix.n_kv_heads == 1 and pix.n_heads == 4
    assert wsp.n_heads == wsp.n_kv_heads == 4 and wsp.encoder_layers == 2
    assert wsp.learned_pos >= MAX_LEN and wsp.norm_type == "layernorm"

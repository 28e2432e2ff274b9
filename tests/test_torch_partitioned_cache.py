"""KV caches split on the sequence or held in int8 on the partitioned
route (``models/attention.py::_attend_split``: each rank appends the new
rows that fall in its shard, takes the partial softmax of every query
over its rows, and the ranks merge the partials by log-sum-exp across
the cache's sequence axes), against the port's unpartitioned route and
the JAX package's ``jax.jit(in_shardings=...)`` steps with the cache laid
out by the reference's ``_cache_pspecs``, on the CPU.

The harness of ``tests/test_torch_partitioned.py`` (``run_cases``): four
``gloo`` ranks, float32, the production rules sized to the mesh with a
case's changes (``"rules"``), the same numpy weights and tokens through
both routes of the port and, in a subprocess with 4 forced host devices,
the reference's jitted steps.  A prefill of 12 tokens, then two decode
steps (rows 12 and 13).  The cases:

* ``qwen3_seq``: reduced Qwen3 at batch 1 on (2, 2), ``cache_seq`` on
  ``data`` (as ``long_500k``'s rules put it) over 16 rows: the prefill
  writes rows 0-11 across both shards of 8;
* ``qwen3_seq_boundary``: the same over 24 rows: the first decode row,
  12, is the first row of the second shard;
* ``qwen3_int8``: the ``--optimized`` decode layout, an int8 cache with
  ``cache_seq`` on ``model`` at batch 4: the 2 KV heads whole on
  ``model`` (``spec``'s first dimension wins), the query heads gathered
  over it and the merged output kept on each rank's heads;
* ``gemma3_seq``: reduced gemma3 (sliding windows on both layers) with
  its window cut to 4, shorter than a shard: at the decode rows the
  first shard holds no key of the window;
* ``recurrentgemma_seq``: reduced recurrentgemma (MQA, window 8) at
  batch 1 over 32 rows: the second shard holds no written key at all;
* ``qwen3_pods``: a (2, 2, 1) ``("pod", "data", "model")`` mesh with
  ``cache_seq`` on ``("pod", "data")``: four shards of 4 rows, merged
  over two mesh dimensions.

Held in ``tests/test_torch_partitioned.py``'s ``LIMITS`` (1e-4 relative
Frobenius on the logits and the cache; recurrentgemma's gradients at
``tests/test_torch_train.py``'s limit); each rank's local cache rows are
held too.  The merge alone (``_merge`` over ``_partials``) is held in
float64 against the whole softmax over 1, 2 and 4 parts of the keys,
with one part fully masked.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from test_torch_partitioned import (LIMITS, hold_jax,  # noqa: E402
                                    hold_unpartitioned, run_cases)
from test_torch_train import GRAD_REL  # noqa: E402

from repro_torch.models import attention as ATT  # noqa: E402

Q3, G3, RG = "qwen3-0.6b", "gemma3-27b", "recurrentgemma-9b"
ON_DATA = {"batch": None, "cache_seq": "data"}
CASES = {
    "qwen3_seq": (Q3, {"vocab_size": 512, "batch": 1, "rules": ON_DATA}),
    "qwen3_seq_boundary": (Q3, {"vocab_size": 512, "batch": 1,
                                "rules": ON_DATA, "max_len": 24}),
    "qwen3_int8": (Q3, {"vocab_size": 512, "int8": True,
                        "rules": {"cache_seq": "model"}}),
    "gemma3_seq": (G3, {"window": 4, "batch": 1, "rules": ON_DATA}),
    "recurrentgemma_seq": (RG, {"batch": 1, "rules": ON_DATA,
                                "max_len": 32}),
    "qwen3_pods": (Q3, {"vocab_size": 512, "batch": 1, "mesh": (2, 2, 1),
                        "rules": {"batch": None,
                                  "cache_seq": ["pod", "data"]}}),
}
# each case's local K rows of one layer stack: (layers, batch, rows, KV
# heads, head_dim) on every rank
LOCAL_K = {"qwen3_seq": [2, 1, 8, 1, 16],
           "qwen3_seq_boundary": [2, 1, 12, 1, 16],
           "qwen3_int8": [2, 2, 8, 2, 16],
           "gemma3_seq": [2, 1, 8, 1, 16],
           "recurrentgemma_seq": [2, 1, 16, 1, 16],
           "qwen3_pods": [2, 1, 4, 2, 16]}


def _limits(name):
    if not name.startswith("recurrentgemma"):
        return LIMITS
    grads = GRAD_REL[RG]
    return {**LIMITS, "grads": grads, "m": max(LIMITS["m"], grads),
            "v": max(LIMITS["v"], 2 * grads)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("partitioned_cache")
    return tmp, run_cases(tmp, CASES, timeout=400)


@pytest.mark.parametrize("name", CASES)
def test_split_cache_equals_unpartitioned(runs, name):
    _, ranks = runs
    hold_unpartitioned(ranks, name, _limits(name))
    for r in ranks:
        assert "prefill" in r[name]["err"] and "cache" in r[name]["err"]


@pytest.mark.parametrize("name", CASES)
def test_split_cache_equals_the_jax_sharded_step(runs, name):
    tmp, _ = runs
    hold_jax(tmp, name, _limits(name))


@pytest.mark.parametrize("name", CASES)
def test_each_rank_holds_its_rows(runs, name):
    """The cache's K leaves keep their local shapes: the sequence split
    over ``data`` (two or four shards), or over ``model`` with the KV
    heads whole."""
    _, ranks = runs
    for r in ranks:
        assert r[name]["cache_k_local"] == [LOCAL_K[name]]


def _softmax_sum(q, k, v, bias):
    """The whole softmax's weighted sums in float64: (B, S, H, D)."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k) / math.sqrt(d) + bias
    w = torch.softmax(logits, -1)
    return torch.einsum("bkgst,btkd->bskgd", w, v).reshape(b, s, h, d)


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_merge_of_partials_equals_the_whole_softmax(parts):
    """``_merge`` of each part's ``_partials``, the parts stacked and
    reduced by max and sum over the stack, against the whole softmax in
    float64: the keys of one part all masked (past the valid rows), a
    window ending inside another part, blocks of 3 keys."""
    gen = torch.Generator().manual_seed(0)
    b, s, h, kvh, d, t = 2, 3, 4, 2, 8, 16
    q = torch.randn(b, s, h, d, generator=gen, dtype=torch.float64)
    k = torch.randn(b, t, kvh, d, generator=gen, dtype=torch.float64)
    v = torch.randn(b, t, kvh, d, generator=gen, dtype=torch.float64)
    valid = t // 2 if parts > 1 else t     # the last part masked
    q_pos = torch.arange(valid - s, valid)
    k_pos = torch.where(torch.arange(t) < valid, torch.arange(t), -10 ** 9)
    window = 6
    want = _softmax_sum(q, k, v, ATT._mask_bias(q_pos, k_pos, True,
                                                window).double())
    rows = t // parts
    got = [ATT._partials(q, k[:, i:i + rows], v[:, i:i + rows], q_pos,
                         k_pos[i:i + rows], True, window, 3)
           for i in range(0, t, rows)]
    if parts > 1:
        assert float(got[-1][0].max()) == ATT.NEG_INF     # fully masked
    m, l, acc = (torch.stack(x) for x in zip(*got))
    out = ATT._merge(m, l, acc, lambda x: x.amax(0, keepdim=True),
                     lambda x: x.sum(0, keepdim=True))[0]
    out = ATT._heads_last(out, q)
    assert out.dtype == torch.float64 and torch.isfinite(out).all()
    assert float((out - want).abs().max()) <= 1e-12


def test_a_fully_masked_part_adds_exact_zeros():
    """A part whose keys are all masked leaves the merge's sums as the
    other parts alone make them, bit for bit."""
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(1, 1, 2, 4, generator=gen, dtype=torch.float64)
    k = torch.randn(1, 8, 1, 4, generator=gen, dtype=torch.float64)
    v = torch.randn(1, 8, 1, 4, generator=gen, dtype=torch.float64)
    q_pos = torch.tensor([3])
    live = ATT._partials(q, k[:, :4], v[:, :4], q_pos, torch.arange(4),
                         True, 0, 4)
    dead = ATT._partials(q, k[:, 4:], v[:, 4:], q_pos,
                         torch.full((4,), -10 ** 9), True, 0, 4)

    def merged(parts):
        m, l, acc = (torch.stack(x) for x in zip(*parts))
        return ATT._merge(m, l, acc, lambda x: x.amax(0, keepdim=True),
                          lambda x: x.sum(0, keepdim=True))
    assert torch.equal(merged([live, dead]), merged([live]))

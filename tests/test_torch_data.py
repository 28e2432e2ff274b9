"""The port's token pipeline (``repro_torch.data.pipeline``, an own copy)
against the JAX package's ``repro.data.pipeline``: the same batches bit
for bit, and the behaviours ``tests/test_data.py`` holds there
(determinism, host sharding, resuming from state, learnable structure)."""
import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe


@pytest.mark.parametrize("kw", [
    dict(vocab_size=100, seq_len=32, global_batch=4, seed=7),
    dict(vocab_size=49152, seq_len=48, global_batch=8, seed=0),
    dict(vocab_size=503, seq_len=17, global_batch=6, seed=3, host_index=1,
         host_count=3),
    dict(vocab_size=50, seq_len=16, global_batch=2, order=3),
])
@pytest.mark.parametrize("step", [0, 1, 9])
def test_batches_bit_identical_to_jax(kw, step):
    got = tpipe.TokenPipeline(**kw).batch_at(step)["tokens"]
    want = jpipe.TokenPipeline(**kw).batch_at(step)["tokens"]
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_iter_from_matches_jax():
    kw = dict(vocab_size=97, seq_len=20, global_batch=3, seed=5)
    it = tpipe.TokenPipeline(**kw).iter_from(tpipe.PipelineState(step=4))
    jit = jpipe.TokenPipeline(**kw).iter_from(jpipe.PipelineState(step=4))
    for _ in range(3):
        (state, batch), (jstate, jbatch) = next(it), next(jit)
        assert state.to_dict() == jstate.to_dict()
        np.testing.assert_array_equal(batch["tokens"], jbatch["tokens"])


def test_deterministic():
    p1 = tpipe.TokenPipeline(vocab_size=100, seq_len=32, global_batch=4,
                             seed=7)
    p2 = tpipe.TokenPipeline(vocab_size=100, seq_len=32, global_batch=4,
                             seed=7)
    np.testing.assert_array_equal(p1.batch_at(5)["tokens"],
                                  p2.batch_at(5)["tokens"])
    assert not np.array_equal(p1.batch_at(5)["tokens"],
                              p1.batch_at(6)["tokens"])


def test_host_shards_differ():
    a = tpipe.TokenPipeline(vocab_size=100, seq_len=32, global_batch=8,
                            host_index=0, host_count=2)
    b = tpipe.TokenPipeline(vocab_size=100, seq_len=32, global_batch=8,
                            host_index=1, host_count=2)
    assert a.local_batch == b.local_batch == 4
    assert not np.array_equal(a.batch_at(0)["tokens"],
                              b.batch_at(0)["tokens"])


def test_state_resume_identical_stream():
    p = tpipe.TokenPipeline(vocab_size=50, seq_len=16, global_batch=2)
    it = p.iter_from(tpipe.PipelineState())
    seen = []
    for _ in range(4):
        _, batch = next(it)
        seen.append(batch["tokens"])
    _, b2 = next(p.iter_from(tpipe.PipelineState(step=2)))
    np.testing.assert_array_equal(seen[2], b2["tokens"])
    state = tpipe.PipelineState.from_dict({"step": "7"})
    assert state.step == 7 and state.to_dict() == {"step": 7}


def test_learnable_structure():
    """The stream is repeat-biased: copy-previous predicts over half."""
    p = tpipe.TokenPipeline(vocab_size=97, seq_len=64, global_batch=4)
    t = p.batch_at(0)["tokens"]
    assert (t[:, :-1] == t[:, 1:]).mean() > 0.5

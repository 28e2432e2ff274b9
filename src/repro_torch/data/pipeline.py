"""Deterministic, checkpointable, shardable synthetic-token data pipeline.

The port's own copy of the JAX package's ``data/pipeline.py`` (numpy
only): the same batches, bit for bit, from the same seed and step.

Production shape: each host generates only its shard of the global batch
(``host_slice``), the stream is a counter-based PRNG (stateless — the
pipeline state is just the step counter, so restore = set the counter),
and batches arrive as numpy so device placement stays under the
trainer's control.  A real deployment swaps ``_synth_doc`` for a tokenized corpus
reader; every interface (state save/restore, sharding, determinism) is
what the checkpoint/restart machinery relies on.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass
class PipelineState:
    step: int = 0

    def to_dict(self) -> Dict:
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d: Dict) -> "PipelineState":
        return cls(step=int(d["step"]))


@dataclass
class TokenPipeline:
    """Markov-chain synthetic LM stream (learnable structure, so smoke
    training shows a decreasing loss)."""
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    order: int = 2          # tokens depend on the previous token mod order

    def __post_init__(self):
        assert self.global_batch % self.host_count == 0
        self.local_batch = self.global_batch // self.host_count

    def _batch_rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_index]))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._batch_rng(step)
        b, s, v = self.local_batch, self.seq_len, self.vocab_size
        # learnable structure: tokens repeat with p=0.6 (bigram identity)
        # over a Zipf-skewed unigram base (marginal is learnable too)
        zipf = np.minimum(rng.zipf(1.5, size=(b, s)) - 1, v - 1).astype(
            np.int32)
        x = np.empty((b, s), np.int32)
        x[:, 0] = zipf[:, 0]
        repeat = rng.random((b, s)) < 0.6
        for t in range(1, s):
            x[:, t] = np.where(repeat[:, t], x[:, t - 1], zipf[:, t])
        return {"tokens": x}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def iter_from(self, state: PipelineState) -> Iterator[
            Tuple[PipelineState, Dict[str, np.ndarray]]]:
        step = state.step
        while True:
            yield PipelineState(step + 1), self.batch_at(step)
            step += 1

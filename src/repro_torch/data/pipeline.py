"""Seekable synthetic data sources (port of ``repro.data.pipeline``).

``batch_at(step)`` is a pure function of ``(seed, step)``: after a crash
and restore the stream resumes bit for bit, with no replay.  Two LM
sources, numpy only, so a seed gives the JAX package's batches exactly:

* ``UniformSynthetic`` — iid tokens (shape and throughput testing);
* ``MarkovSynthetic`` — a fixed random bigram chain, which a model
  visibly learns, so convergence tests have signal.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class UniformSynthetic:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0

    def batch_at(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        return rng.integers(0, self.vocab, (self.batch, self.seq_len),
                            dtype=np.int32)


@dataclasses.dataclass
class MarkovSynthetic:
    """Tokens follow a sparse random bigram table (``branching`` likely
    successors a token): a cross-entropy floor near log(branching)
    instead of log(vocab)."""

    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    branching: int = 8

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.successors = rng.integers(
            0, self.vocab, (self.vocab, self.branching), dtype=np.int32)

    def batch_at(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, 1, step))
        out = np.empty((self.batch, self.seq_len), np.int32)
        cur = rng.integers(0, self.vocab, self.batch, dtype=np.int32)
        out[:, 0] = cur
        choices = rng.integers(0, self.branching,
                               (self.batch, self.seq_len), dtype=np.int32)
        for t in range(1, self.seq_len):
            cur = self.successors[cur, choices[:, t]]
            out[:, t] = cur
        return out


def make_source(kind: str, vocab: int, seq_len: int, batch: int,
                seed: int = 0):
    if kind == "uniform":
        return UniformSynthetic(vocab, seq_len, batch, seed)
    if kind == "markov":
        return MarkovSynthetic(vocab, seq_len, batch, seed)
    raise ValueError(kind)

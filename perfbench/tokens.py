"""The benchmark's token traffic for LM training, and the vocabulary's
auxiliary matrix that Algorithm 1 encodes: a copy of the arithmetic of
``repro_torch.data.tokens`` (a latent Markov chain of topics, each
emitting Zipf-ranked tokens through its own permutation of the
vocabulary; a co-occurrence pass through a count sketch), vectorised over
the sequence, so the benchmark owns its inputs.

Every step's batch is drawn from ``(seed, step)``: rows never repeat
between steps, and every seed gives the same shapes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class TokenSource:
    """``next_batch()`` -> {"tokens": (B, S) int32, "labels": (B, S) int32},
    the labels the tokens shifted by one."""

    def __init__(self, vocab_size: int, batch: int, seq: int, seed: int, n_topics: int = 64,
                 zipf_a: float = 1.2, topic_stickiness: float = 0.98):
        self.vocab_size, self.batch, self.seq, self.seed = vocab_size, batch, seq, seed
        self.n_topics, self.stickiness = n_topics, topic_stickiness
        base = np.random.default_rng([seed, 0])
        self.topic_perm = np.stack([base.permutation(vocab_size) for _ in range(n_topics)])
        ranks = 1.0 / np.arange(1, vocab_size + 1) ** zipf_a
        self.cdf = np.cumsum(ranks / ranks.sum())
        self.step = 0

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng([self.seed, 1, self.step])
        B, S, T = self.batch, self.seq, self.n_topics
        first = rng.integers(0, T, B)
        switch = rng.random((B, S)) > self.stickiness
        new = rng.integers(0, T, (B, S))
        at = np.where(switch, np.arange(S), -1)
        last = np.maximum.accumulate(at, axis=1)
        rows = np.arange(B)[:, None]
        topics = np.concatenate(
            [first[:, None], np.where(last >= 0, new[rows, np.maximum(last, 0)], first[:, None])],
            axis=1)
        ranks = np.minimum(np.searchsorted(self.cdf, rng.random((B, S + 1)), side="right"),
                           self.vocab_size - 1)
        tokens = self.topic_perm[topics, ranks].astype(np.int32)
        self.step += 1
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def cooccurrence(source: TokenSource, n_batches: int, rows: int, window: int = 8,
                 projection_dim: int = 512, seed: int = 17) -> np.ndarray:
    """(rows, projection_dim) float32: each token's co-occurrence counts
    within ``window`` positions, through a count sketch (a random column
    and sign a token), each row scaled to unit norm; rows past the
    vocabulary (its padding) stay zero."""
    V = source.vocab_size
    rng = np.random.default_rng([seed, V])
    signs = rng.choice([-1.0, 1.0], size=V).astype(np.float32)
    cols = rng.integers(0, projection_dim, V)
    A = np.zeros((rows, projection_dim), np.float32)
    for _ in range(n_batches):
        toks = source.next_batch()["tokens"]
        for off in range(1, window + 1):
            a, b = toks[:, :-off].ravel(), toks[:, off:].ravel()
            np.add.at(A, (a, cols[b]), signs[b])
            np.add.at(A, (b, cols[a]), signs[a])
    norms = np.linalg.norm(A, axis=1, keepdims=True)
    return A / np.maximum(norms, 1e-6)

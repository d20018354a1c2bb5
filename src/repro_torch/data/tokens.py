"""Synthetic LM token pipeline (counterpart of ``repro/data/tokens.py``).

A latent Markov topic chain drives Zipf-distributed token emission, giving
the stream real co-occurrence structure — the auxiliary signal the paper's
LSH coding consumes (tokens of one topic hash to nearby codes, the
vocabulary analogue of adjacency rows).

Plain numpy, the JAX package's code line for line, so the same seed gives
the same batches bit for bit.  ``TokenStream`` is deterministic in (seed,
shard, position) and exposes ``state_dict``/``load_state_dict``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    batch_size: int          # per-host batch
    n_topics: int = 64
    zipf_a: float = 1.2
    topic_stickiness: float = 0.98
    seed: int = 0
    shard: int = 0           # data-parallel shard id
    n_shards: int = 1


class TokenStream:
    def __init__(self, cfg: TokenStreamConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        V, T = cfg.vocab_size, cfg.n_topics
        # per-topic token distribution: Zipf ranks permuted per topic
        ranks = 1.0 / np.arange(1, V + 1) ** cfg.zipf_a
        self.topic_perm = np.stack([
            base.permutation(V) for _ in range(T)
        ])
        self.topic_probs = ranks / ranks.sum()
        self.step = 0

    def _rng(self, step: int) -> np.random.Generator:
        # deterministic per (seed, shard, step): restart-safe
        return np.random.default_rng(
            (self.cfg.seed * 1_000_003 + self.cfg.shard) * 1_000_003 + step
        )

    def next_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._rng(self.step)
        B, S, T = cfg.batch_size, cfg.seq_len, cfg.n_topics
        topics = np.empty((B, S + 1), np.int64)
        topics[:, 0] = rng.integers(0, T, B)
        switch = rng.random((B, S)) > cfg.topic_stickiness
        new_topics = rng.integers(0, T, (B, S))
        for t in range(S):
            topics[:, t + 1] = np.where(switch[:, t], new_topics[:, t], topics[:, t])
        ranks = rng.choice(cfg.vocab_size, size=(B, S + 1), p=self.topic_probs)
        tokens = self.topic_perm[topics, ranks].astype(np.int32)
        self.step += 1
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    # -- checkpointable state -------------------------------------------
    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.cfg.seed, "shard": self.cfg.shard}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        assert state["seed"] == self.cfg.seed and state["shard"] == self.cfg.shard, \
            "restoring a token stream from a different run"
        self.step = int(state["step"])


def cooccurrence_matrix(
    stream: TokenStream, n_batches: int, window: int = 8,
    projection_dim: Optional[int] = 1024, seed: int = 17,
) -> np.ndarray:
    """One streaming pass building the vocabulary auxiliary matrix A for
    Algorithm 1 (the token analogue of the adjacency matrix).

    The full co-occurrence matrix is (V, V); we accumulate it through a
    count-sketch style random projection to (V, projection_dim) so the pass
    is O(V·p) memory — at V=152k full co-occurrence would be 92 GB, the
    projected one is 0.6 GB.  Random projection preserves the inner-product
    geometry LSH needs (Johnson–Lindenstrauss), and Algorithm 1 itself is
    projection-based, so this composes two projections.
    """
    V = stream.cfg.vocab_size
    p = projection_dim or V
    rng = np.random.default_rng(seed)
    signs = rng.choice([-1.0, 1.0], size=V).astype(np.float32)
    cols = rng.integers(0, p, V)
    A = np.zeros((V, p), np.float32)
    for _ in range(n_batches):
        toks = stream.next_batch()["tokens"]
        for row in toks:
            for off in range(1, window + 1):
                a, b = row[:-off], row[off:]
                np.add.at(A, (a, cols[b]), signs[b])
                np.add.at(A, (b, cols[a]), signs[a])
    # row-normalise (degree normalisation analogue)
    norms = np.linalg.norm(A, axis=1, keepdims=True)
    return A / np.maximum(norms, 1e-6)

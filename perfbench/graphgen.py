"""The benchmark's graph generator: a seeded power-law graph with planted
communities, vectorised in numpy.

``powerlaw_edges`` gives exactly ``n_edges`` distinct undirected edges
with no self loops over ``n_nodes`` nodes, and one community label a node.
``relabelled`` renames the nodes by a seeded permutation: every run seed
gets the same graph, with the same degrees and communities, in another
order, so the seed changes the inputs and not the work a step does (a
sparse product's time follows the degrees).

A node's expected degree follows its propensity ``w_i`` (Pareto, tail
exponent ``degree_exponent``, so a few hubs hold thousands of edges as
ogbn-arxiv's do).  An edge picks its source in proportion to ``w``; with
probability ``homophily`` its target comes from the source's community,
else from all nodes, again in proportion to ``w``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def powerlaw_edges(seed: int, n_nodes: int, n_edges: int, n_classes: int,
                   homophily: float, degree_exponent: float
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(src, dst, labels): int64 arrays, ``src < dst`` on every edge, the
    edges in the order they were first drawn."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes)
    w = rng.pareto(degree_exponent - 1.0, n_nodes) + 1.0
    cdf = np.cumsum(w)
    by_class = np.argsort(labels, kind="stable")
    class_cdf = np.cumsum(w[by_class])
    ends = np.cumsum(np.bincount(labels, minlength=n_classes))
    starts = ends - np.bincount(labels, minlength=n_classes)
    lo = np.where(starts > 0, class_cdf[np.maximum(starts - 1, 0)], 0.0)
    hi = class_cdf[np.maximum(ends - 1, 0)]

    keys = np.empty(0, np.int64)
    while keys.shape[0] < n_edges:
        k = int((n_edges - keys.shape[0]) * 1.1) + 1024
        src = np.searchsorted(cdf, rng.random(k) * cdf[-1], side="right")
        src = np.minimum(src, n_nodes - 1)
        cls = labels[src]
        inside = rng.random(k) < homophily
        u = lo[cls] + rng.random(k) * (hi[cls] - lo[cls])
        j = np.minimum(np.searchsorted(class_cdf, u, side="right"), n_nodes - 1)
        local = by_class[j]
        glob = np.minimum(np.searchsorted(cdf, rng.random(k) * cdf[-1], side="right"),
                          n_nodes - 1)
        dst = np.where(inside, local, glob)
        a, b = np.minimum(src, dst), np.maximum(src, dst)
        drawn = (a * n_nodes + b)[a != b]
        keys = np.concatenate([keys, drawn])
        _, first = np.unique(keys, return_index=True)
        keys = keys[np.sort(first)]
    keys = keys[:n_edges]
    return keys // n_nodes, keys % n_nodes, labels


def relabelled(src: np.ndarray, dst: np.ndarray, labels: np.ndarray, seed: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The same graph with node i renamed ``perm[i]`` (a permutation drawn
    from ``seed``), its edges shuffled, ``src < dst`` on every edge."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(labels.shape[0])
    a, b = perm[src], perm[dst]
    order = rng.permutation(a.shape[0])
    a, b = a[order], b[order]
    out = np.empty_like(labels)
    out[perm] = labels
    return np.minimum(a, b), np.maximum(a, b), out

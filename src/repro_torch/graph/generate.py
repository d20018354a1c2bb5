"""Synthetic graph generators (counterpart of ``repro/graph/generate.py``).

Pure numpy and deterministic in their seed: the same seed gives the
identical graph and labels as the JAX package's generators.

* ``powerlaw_graph`` — preferential-attachment graph (heavy-tailed degree)
                       with planted community labels.
* ``sbm_graph``      — stochastic-block-model graph (clean community signal).
* ``bipartite_transaction_graph`` — consumer × merchant graph (paper §5.3).
* ``holdout_edges``  — the link-prediction split (paper §5.2).
* ``clustered_embeddings`` — Gaussian-mixture "pre-trained embeddings" with
                       planted labels (the reconstruction experiment's input).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.graph.csr import CSRMatrix


def powerlaw_graph(
    seed: int,
    n_nodes: int,
    avg_degree: int = 8,
    n_classes: int = 16,
    homophily: float = 0.8,
) -> Tuple[CSRMatrix, np.ndarray]:
    """Barabási–Albert-style preferential attachment with community-biased
    attachment; returns (symmetric CSR adjacency, node labels).

    ``homophily`` is the probability that a new edge attaches within the
    node's own community (label signal strength).
    """
    rng = np.random.default_rng(seed)
    k = max(1, avg_degree // 2)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)

    src = np.empty(n_nodes * k, np.int64)
    dst = np.empty(n_nodes * k, np.int64)
    n0 = k + 1                                  # seed clique
    e = 0
    for i in range(1, n0):
        for j in range(i):
            if e < src.shape[0]:
                src[e], dst[e] = i, j
                e += 1
    # target pool for preferential attachment (endpoint repetition = degree bias)
    pool = np.concatenate([src[:e], dst[:e]])
    pool_by_class = [np.where(labels == cl)[0] for cl in range(n_classes)]
    for i in range(n0, n_nodes):
        same = rng.random(k) < homophily
        t_pref = pool[rng.integers(0, max(len(pool), 1), k)] if len(pool) else rng.integers(0, i, k)
        cls_pool = pool_by_class[labels[i]]
        cls_pool = cls_pool[cls_pool < i]
        if cls_pool.size:
            t_homo = cls_pool[rng.integers(0, cls_pool.size, k)]
        else:
            t_homo = rng.integers(0, i, k)
        targets = np.where(same, t_homo, t_pref)
        targets = np.minimum(targets, i - 1)
        src[e: e + k] = i
        dst[e: e + k] = targets
        e += k
        if i % 512 == 0:  # grow the pool occasionally (amortised)
            pool = np.concatenate([src[:e], dst[:e]])
    return CSRMatrix.from_edges(src[:e], dst[:e], n_nodes, symmetric=True), labels


def sbm_graph(
    seed: int,
    n_nodes: int,
    n_classes: int = 8,
    p_in: float = 0.02,
    p_out: float = 0.002,
    labels: "np.ndarray" = None,
) -> Tuple[CSRMatrix, np.ndarray]:
    """Sparse stochastic block model via per-node expected-degree sampling.
    ``labels`` pins the community assignment."""
    rng = np.random.default_rng(seed)
    if labels is None:
        labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    labels = np.asarray(labels, np.int32)
    per_cls = [np.where(labels == cl)[0] for cl in range(n_classes)]
    exp_in = p_in * n_nodes / n_classes
    exp_out = p_out * n_nodes * (n_classes - 1) / n_classes
    srcs, dsts = [], []
    for i in range(n_nodes):
        k_in = rng.poisson(exp_in)
        k_out = rng.poisson(exp_out)
        cp = per_cls[labels[i]]
        if k_in and cp.size:
            srcs.append(np.full(k_in, i))
            dsts.append(cp[rng.integers(0, cp.size, k_in)])
        if k_out:
            srcs.append(np.full(k_out, i))
            dsts.append(rng.integers(0, n_nodes, k_out))
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    keep = src != dst
    return CSRMatrix.from_edges(src[keep], dst[keep], n_nodes, symmetric=True), labels


def bipartite_transaction_graph(
    seed: int,
    n_consumers: int,
    n_merchants: int,
    n_categories: int = 64,
    avg_tx_per_consumer: int = 12,
    consumer_affinity: int = 3,
) -> Tuple[CSRMatrix, np.ndarray, int]:
    """Consumer–merchant bipartite graph (paper §5.3 stand-in).

    Nodes [0, n_consumers) are consumers, [n_consumers, n) merchants.
    Each consumer has ``consumer_affinity`` preferred categories; its
    transactions go to merchants of those categories with a Zipf
    popularity bias, which gives the category signal and the degree
    imbalance the paper describes.  Returns (adjacency, merchant_labels,
    n_consumers).
    """
    rng = np.random.default_rng(seed)
    n = n_consumers + n_merchants
    merchant_cat = rng.integers(0, n_categories, n_merchants).astype(np.int32)
    merchants_by_cat = [np.where(merchant_cat == cl)[0] for cl in range(n_categories)]
    pop = {}                                    # Zipf popularity within a category
    for cl in range(n_categories):
        sz = merchants_by_cat[cl].size
        if sz:
            w = 1.0 / np.arange(1, sz + 1) ** 1.1
            pop[cl] = w / w.sum()
    srcs, dsts = [], []
    aff = rng.integers(0, n_categories, (n_consumers, consumer_affinity))
    for i in range(n_consumers):
        k = max(1, rng.poisson(avg_tx_per_consumer))
        cats = aff[i, rng.integers(0, consumer_affinity, k)]
        tgt = np.empty(k, np.int64)
        for j, cl in enumerate(cats):
            mbc = merchants_by_cat[cl]
            if mbc.size:
                tgt[j] = mbc[rng.choice(mbc.size, p=pop[cl])]
            else:
                tgt[j] = rng.integers(0, n_merchants)
        srcs.append(np.full(k, i))
        dsts.append(tgt + n_consumers)
    adj = CSRMatrix.from_edges(np.concatenate(srcs), np.concatenate(dsts), n,
                               symmetric=True)
    return adj, merchant_cat, n_consumers


def clustered_embeddings(
    seed: int,
    n: int,
    dim: int,
    n_clusters: int = 8,
    noise: float = 0.35,
) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussian-mixture 'pre-trained embeddings' + planted labels.

    Cluster centres are random orthogonal-ish directions; ``noise`` controls
    intra-cluster spread (≈ metapath2vec's NMI-recoverable structure)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    labels = rng.integers(0, n_clusters, n).astype(np.int32)
    emb = centers[labels] + noise * rng.standard_normal((n, dim)).astype(np.float32)
    return emb.astype(np.float32), labels


def train_val_test_split(seed: int, n: int, frac=(0.7, 0.1, 0.2)):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_tr = int(frac[0] * n)
    n_va = int(frac[1] * n)
    return perm[:n_tr], perm[n_tr: n_tr + n_va], perm[n_tr + n_va:]


def holdout_edges(seed: int, adj: CSRMatrix, frac: float = 0.1):
    """Link-prediction split: (train_adj, pos_eval_edges (E, 2)).  The
    held-out edges leave the training adjacency in both directions."""
    rng = np.random.default_rng(seed)
    rid, cid = adj.row_ids(), adj.indices
    upper = rid < cid
    er, ec = rid[upper], cid[upper]
    n_hold = int(frac * er.shape[0])
    hold = rng.choice(er.shape[0], n_hold, replace=False)
    mask = np.zeros(er.shape[0], bool)
    mask[hold] = True
    keep_r = np.concatenate([er[~mask], ec[~mask]])
    keep_c = np.concatenate([ec[~mask], er[~mask]])
    train = CSRMatrix.from_coo(keep_r, keep_c, np.ones_like(keep_r, np.float32), adj.shape)
    return train, np.stack([er[mask], ec[mask]], axis=1)

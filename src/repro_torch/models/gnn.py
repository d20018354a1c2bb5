"""The paper's GNN stack (§4/§5.2): GraphSAGE, GCN, SGC and GIN with the
compressed-embedding layer as their input features; counterpart of
``repro/models/gnn.py``.

GraphSAGE follows Figure 4: sample -> code lookup -> decode ->
mean-aggregate -> concat -> linear(+ReLU), two layers.  Params are a dict
of tensors in the JAX package's layout (``x @ w``, w of shape (in, out)).
The frontier forward has two hot-node-cached twins (``_cached``, and
``_missonly`` for a miss-first permuted frontier).

GCN / SGC / GIN are full-graph (paper §C.1 trains them without
minibatches): every step decodes ALL nodes in one call and multiplies by
the normalised adjacency (``graph.csr.DeviceCSR``).  Link prediction
(§5.2): dot-product scores, a logistic loss over positive and uniform
negative pairs, hits@K; the merchant task (§5.3) reads hit@k.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import GNNConfig
from repro_torch.core import embedding as emb_lib
from repro_torch.core.backend import CachedDecodeBackend
from repro_torch.core.decoder import Params
from repro_torch.graph.sampler import FrontierBatch
from repro_torch.nn.module import dense_init
from repro_torch.parallel import sharding
from repro_torch.stages import stage

def init_gnn(generator: torch.Generator, cfg: GNNConfig,
             codes: Optional[torch.Tensor] = None, aux=None) -> Params:
    """The JAX package's leaves: SAGE and GCN ``w1 b1 w2 b2``, SGC ``w1
    b1``, GIN 0-d ``eps1 eps2`` and two-layer ``mlp1`` / ``mlp2``; with
    ``task="node"`` also ``w_out b_out``."""
    if cfg.model not in ("sage", "gcn", "sgc", "gin"):
        raise ValueError(cfg.model)
    dev = generator.device
    params: Params = {"embed": emb_lib.init_embedding(
        generator, cfg.embedding_config(), codes=codes, aux=aux)}
    d_e, H = cfg.d_e, cfg.hidden

    def linear(i: str, d_in: int, tree: Params):       # w{i} (d_in, H), b{i}
        tree[f"w{i}"] = dense_init(generator, (d_in, H))
        tree[f"b{i}"] = torch.zeros(H, device=dev)
        return tree

    if cfg.model == "gin":
        params["eps1"] = torch.zeros((), device=dev)
        params["eps2"] = torch.zeros((), device=dev)
        params["mlp1"] = linear("2", H, linear("1", d_e, {}))
        params["mlp2"] = linear("2", H, linear("1", H, {}))
    else:
        linear("1", 2 * d_e if cfg.model == "sage" else d_e, params)
        if cfg.model != "sgc":
            linear("2", 2 * H if cfg.model == "sage" else H, params)
    if cfg.task == "node":
        params["w_out"] = dense_init(generator, (H, cfg.n_classes))
        params["b_out"] = torch.zeros(cfg.n_classes, device=dev)
    return params


def _sage_combine(params, h0: torch.Tensor, h1: torch.Tensor,
                  h2: torch.Tensor) -> torch.Tensor:
    """Figure-4 aggregate/concat/linear stack on decoded level features
    h0 (B, de), h1 (B, f1, de), h2 (B, f1, f2, de)."""
    agg0 = h1.mean(dim=1)
    z0 = torch.relu(torch.cat([agg0, h0], -1) @ params["w1"] + params["b1"])
    agg1 = h2.mean(dim=2)
    z1 = torch.relu(torch.cat([agg1, h1], -1) @ params["w1"] + params["b1"])
    aggz = z1.mean(dim=1)
    return torch.relu(torch.cat([aggz, z0], -1) @ params["w2"] + params["b2"])


def sage_forward(params, levels: List[torch.Tensor], cfg: GNNConfig,
                 backend=None) -> torch.Tensor:
    """Naive path — levels: [targets (B,), l1 (B,f1), l2 (B,f1,f2)] node ids
    (tensors), each decoded independently."""
    ecfg = cfg.embedding_config()
    h = [emb_lib.embed_lookup(params["embed"], ids, ecfg, backend=backend)
         for ids in levels[:3]]
    return _sage_combine(params, *h)


def sage_forward_frontier(params, fb: FrontierBatch, cfg: GNNConfig,
                          backend=None) -> torch.Tensor:
    """Dedup-decode path: ONE decode over the unique frontier (a tensor
    ``FrontierBatch``), then gathers rebuild the per-level tensors.  The
    gathers are ``F.embedding``, whose backward sums each frontier row's
    gradients in a fixed order on both devices (``hu[m]``'s backward, an
    accumulating ``index_put_``, adds them with atomics on the CPU), so a
    step's gradients are the same bits on every run.  A batch that carries
    its packed code rows (``fb.codes``, codes kept on the host) decodes
    them in place of the ``codes_buf`` gather.

    Under a mesh of several ranks ``fb`` is this rank's placed block of a
    stacked sharded frontier (``parallel.policy``): the decode backend
    returns every rank's rows (the ``OwnerPlan`` ``fb.plan`` routes the
    owner-computes decode), and the rest runs on the whole batch."""
    hu = emb_lib.embed_lookup(params["embed"], fb.unique, cfg.embedding_config(),
                              backend=backend, codes=fb.codes, frontier=True,
                              plan=fb.plan)                         # (U, de)
    return _levels(params, hu, fb)


def _whole_frontier(fb: FrontierBatch):
    """``(ids, valid)`` of the whole frontier: under a mesh of several
    ranks every rank's placed blocks, all-gathered in rank order."""
    ids, valid = fb.unique, fb.valid_mask()
    mesh = sharding.current_mesh()
    if sharding.data_axis_size(mesh) > 1:
        ids = torch.cat(mesh.all_gather(ids))
        valid = torch.cat(mesh.all_gather(valid.to(torch.uint8))).bool()
    return ids, valid


def _levels(params, hu: torch.Tensor, fb: FrontierBatch) -> torch.Tensor:
    with stage("sage"):
        return _sage_combine(params, *(F.embedding(m, hu) for m in fb.index_maps[:3]))


def sage_forward_frontier_cached(params, fb: FrontierBatch, cfg: GNNConfig,
                                 cache_state, backend=None):
    """Hot-node-cached twin of ``sage_forward_frontier``: the unique-frontier
    decode goes through a ``CachedDecodeBackend`` keyed by node id, so ids
    whose cached embedding is within the staleness budget are served from
    the cache (no gradient) and the rest decode fresh and are written back.
    The frontier's padding rows are masked out of the cache.  ``lookup``
    hands ``decode_fn`` the whole frontier in order, so the batch's code
    rows go with it as they are.  Returns ``(hidden, new_cache_state)``."""
    ecfg = cfg.embedding_config()
    cache = CachedDecodeBackend(staleness=ecfg.cache_staleness)
    # the cache (whole on every rank) keys the whole frontier; the decode
    # it wraps is the frontier's, plan included
    ids, valid = _whole_frontier(fb)
    hu, new_state = cache.lookup(
        cache_state, ids,
        lambda _: emb_lib.embed_lookup(params["embed"], fb.unique, ecfg, backend=backend,
                                       codes=fb.codes, frontier=True, plan=fb.plan),
        valid=valid)
    return _levels(params, hu, fb), new_state


def sage_forward_frontier_missonly(params, fb: FrontierBatch, cfg: GNNConfig,
                                   cache_state, n_decode: int, backend=None,
                                   buffers=None):
    """Miss-only twin of ``sage_forward_frontier_cached``: the frontier was
    permuted miss-first on the host (``CachedDecodeBackend.plan_missonly``),
    so only its first ``n_decode`` rows enter the decoder and every other
    valid row is served from the cache; the batch's code rows, aligned
    with the permuted frontier, are cut to the same prefix.  Returns
    ``(hidden, new_cache_state)``; with ``buffers`` the cache is updated in
    place (``CachedDecodeBackend.lookup_missonly``)."""
    if sharding.data_axis_size() > 1:
        raise ValueError("a miss-first permuted frontier is single-shard only: the "
                         "permutation breaks the stacked per-shard row blocks")
    ecfg = cfg.embedding_config()
    cache = CachedDecodeBackend(staleness=ecfg.cache_staleness)
    hu, new_state = cache.lookup_missonly(
        cache_state, fb.unique,
        lambda i: emb_lib.embed_lookup(
            params["embed"], i, ecfg, backend=backend,
            codes=None if fb.codes is None else fb.codes[:i.shape[0]]),
        n_decode, valid=fb.valid_mask(), buffers=buffers)
    return _levels(params, hu, fb), new_state


# ---------------------------------------------------------------------------
# full-graph models
# ---------------------------------------------------------------------------

def _all_features(params, cfg: GNNConfig, backend=None) -> torch.Tensor:
    """Every node's input features: the dense table, or ONE decode of
    ``arange(n_nodes)`` through ``backend`` (on the card the
    ``hash_decode`` kernel, and its backward kernel in training)."""
    ecfg = cfg.embedding_config()
    if ecfg.kind == "dense":
        return params["embed"]["table"]
    dev = params["embed"]["decoder"]["mlp"]["w0"].device
    ids = torch.arange(cfg.n_nodes, device=dev)
    return emb_lib.embed_lookup(params["embed"], ids, ecfg, backend=backend)


def fullgraph_forward(params, adj_norm, cfg: GNNConfig, backend=None) -> torch.Tensor:
    """Final hidden for all nodes (n, H); ``adj_norm`` is the normalised
    adjacency on the params' device (``CSRMatrix.on``)."""
    X = _all_features(params, cfg, backend)

    def spmm(h):
        with stage("spmm"):
            return adj_norm.matmat(h)

    if cfg.model == "gcn":
        h = torch.relu(spmm(X) @ params["w1"] + params["b1"])
        return spmm(h) @ params["w2"] + params["b2"]
    if cfg.model == "sgc":
        return spmm(spmm(X)) @ params["w1"] + params["b1"]
    if cfg.model == "gin":
        def gmlp(m, h):
            return torch.relu(h @ m["w1"] + m["b1"]) @ m["w2"] + m["b2"]
        h = torch.relu(gmlp(params["mlp1"], (1 + params["eps1"]) * X + spmm(X)))
        return gmlp(params["mlp2"], (1 + params["eps2"]) * h + spmm(h))
    raise ValueError(cfg.model)


# ---------------------------------------------------------------------------
# losses / metrics
# ---------------------------------------------------------------------------

def node_logits(params, hidden: torch.Tensor, cfg: GNNConfig) -> torch.Tensor:
    return hidden @ params["w_out"] + params["b_out"]


def node_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[:, None])[:, 0]
    return (logz - gold).mean()


def link_scores(hidden: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """edges (E, 2) -> dot-product scores (E,).  The row gathers are
    ``F.embedding``, whose backward sums a node's repeated rows in a fixed
    order (an edge list repeats nodes)."""
    edges = torch.as_tensor(edges, device=hidden.device).to(torch.int64)
    return (F.embedding(edges[:, 0], hidden) * F.embedding(edges[:, 1], hidden)).sum(-1)


def link_loss(hidden: torch.Tensor, pos_edges, neg_edges) -> torch.Tensor:
    """softplus(-pos) + softplus(neg), each a mean; softplus is
    ``logaddexp(x, 0)`` as JAX's (``F.softplus`` turns linear past 20)."""
    pos = link_scores(hidden, pos_edges)
    neg = link_scores(hidden, neg_edges)
    zero = torch.zeros((), device=hidden.device)
    return torch.logaddexp(-pos, zero).mean() + torch.logaddexp(neg, zero).mean()


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def hits_at_k(pos_scores, neg_scores, k: int) -> float:
    """OGB hits@K: the fraction of positives scored above the K-th
    highest negative."""
    neg = np.sort(_np(neg_scores))[::-1]
    thresh = neg[min(k, len(neg)) - 1]
    return float((_np(pos_scores) > thresh).mean())


def accuracy(logits, labels) -> float:
    pred = torch.as_tensor(logits).argmax(-1).cpu().numpy()
    return float((pred == np.asarray(torch.as_tensor(labels).cpu())).mean())


def hit_rate_at_k(logits, labels, k: int) -> float:
    """§5.3 hit@k: the label is among the k top-scored categories.  At a
    tie the lower category index enters the top k first, as in
    ``jax.lax.top_k`` (a stable descending sort)."""
    logits = torch.as_tensor(logits)
    topk = torch.sort(logits, dim=-1, descending=True, stable=True).indices[..., :k]
    labels = torch.as_tensor(labels).to(topk.device, torch.int64)
    return float(np.mean(_np((topk == labels[:, None]).any(dim=1))))

"""The paper's GraphSAGE (§4/§5.2) with the compressed-embedding layer as
its input features; counterpart of the SAGE part of ``repro/models/gnn.py``.

GraphSAGE follows Figure 4: sample -> code lookup -> decode ->
mean-aggregate -> concat -> linear(+ReLU), two layers.  Params are a dict
of tensors in the JAX package's layout (``x @ w``, w of shape (in, out)).
The frontier forward has two hot-node-cached twins (``_cached``, and
``_missonly`` for a miss-first permuted frontier).
The full-graph models (GCN, SGC, GIN) come with a later slice.
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
from repro_torch.stages import stage

FULLGRAPH_SLICE = "the full-graph slice (ROADMAP A.12)"


def init_gnn(generator: torch.Generator, cfg: GNNConfig,
             codes: Optional[torch.Tensor] = None, aux=None) -> Params:
    if cfg.model != "sage":
        raise NotImplementedError(
            f"model {cfg.model!r} is not ported yet; it comes with {FULLGRAPH_SLICE}")
    dev = generator.device
    params: Params = {"embed": emb_lib.init_embedding(
        generator, cfg.embedding_config(), codes=codes, aux=aux)}
    d_e, H = cfg.d_e, cfg.hidden
    params["w1"] = dense_init(generator, (2 * d_e, H))
    params["b1"] = torch.zeros(H, device=dev)
    params["w2"] = dense_init(generator, (2 * H, H))
    params["b2"] = torch.zeros(H, device=dev)
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
    step's gradients are the same bits on every run."""
    hu = emb_lib.embed_lookup(params["embed"], fb.unique, cfg.embedding_config(),
                              backend=backend)                      # (U, de)
    return _levels(params, hu, fb)


def _levels(params, hu: torch.Tensor, fb: FrontierBatch) -> torch.Tensor:
    with stage("sage"):
        return _sage_combine(params, *(F.embedding(m, hu) for m in fb.index_maps[:3]))


def sage_forward_frontier_cached(params, fb: FrontierBatch, cfg: GNNConfig,
                                 cache_state, backend=None):
    """Hot-node-cached twin of ``sage_forward_frontier``: the unique-frontier
    decode goes through a ``CachedDecodeBackend`` keyed by node id, so ids
    whose cached embedding is within the staleness budget are served from
    the cache (no gradient) and the rest decode fresh and are written back.
    The frontier's padding rows are masked out of the cache.  Returns
    ``(hidden, new_cache_state)``."""
    ecfg = cfg.embedding_config()
    cache = CachedDecodeBackend(staleness=ecfg.cache_staleness)
    hu, new_state = cache.lookup(
        cache_state, fb.unique,
        lambda i: emb_lib.embed_lookup(params["embed"], i, ecfg, backend=backend),
        valid=fb.valid_mask())
    return _levels(params, hu, fb), new_state


def sage_forward_frontier_missonly(params, fb: FrontierBatch, cfg: GNNConfig,
                                   cache_state, n_decode: int, backend=None,
                                   buffers=None):
    """Miss-only twin of ``sage_forward_frontier_cached``: the frontier was
    permuted miss-first on the host (``CachedDecodeBackend.plan_missonly``),
    so only its first ``n_decode`` rows enter the decoder and every other
    valid row is served from the cache.  Returns ``(hidden,
    new_cache_state)``; with ``buffers`` the cache is updated in place
    (``CachedDecodeBackend.lookup_missonly``)."""
    ecfg = cfg.embedding_config()
    cache = CachedDecodeBackend(staleness=ecfg.cache_staleness)
    hu, new_state = cache.lookup_missonly(
        cache_state, fb.unique,
        lambda i: emb_lib.embed_lookup(params["embed"], i, ecfg, backend=backend),
        n_decode, valid=fb.valid_mask(), buffers=buffers)
    return _levels(params, hu, fb), new_state


def node_logits(params, hidden: torch.Tensor, cfg: GNNConfig) -> torch.Tensor:
    return hidden @ params["w_out"] + params["b_out"]


def node_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[:, None])[:, 0]
    return (logz - gold).mean()


def accuracy(logits, labels) -> float:
    pred = torch.as_tensor(logits).argmax(-1).cpu().numpy()
    return float((pred == np.asarray(torch.as_tensor(labels).cpu())).mean())

"""Unified GNN model entry point (counterpart of the model part of
``repro/graph/engine.py``).

``GNNModel.apply(params, batch)`` accepts a ``FrontierBatch`` (dedup-decode
GraphSAGE) or a naive level list, with the decode backend resolved once
from the config's ``lookup_impl`` for the model's device.  Batch sources,
prefetch and the training step come with the training slice.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.core.backend import get_backend
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.sampler import FrontierBatch
from repro_torch.models import gnn
from repro_torch.stages import stage

Batch = Union[FrontierBatch, Sequence[Any]]


class GNNModel:
    """Single entry point over the ported GNN family (GraphSAGE).

    ``apply`` moves host batches to the model's device: a ``FrontierBatch``
    runs the dedup-decode forward, a list of levels the naive one.
    Inference only: it runs under ``torch.no_grad``."""

    def __init__(self, cfg: GNNConfig, device: DeviceLike = None,
                 backend: Optional[str] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        policy = cfg.embedding_config().decoder_config().precision_policy()
        self.backend = get_backend(backend or cfg.embedding.lookup_impl,
                                   device=self.device, policy=policy)

    def init(self, generator: torch.Generator, codes=None, aux=None):
        return gnn.init_gnn(generator, self.cfg, codes=codes, aux=aux)

    @torch.no_grad()
    def apply(self, params, batch: Batch) -> torch.Tensor:
        if isinstance(batch, FrontierBatch):
            with stage("h2d"):
                batch = batch.to(self.device)
            return gnn.sage_forward_frontier(params, batch, self.cfg,
                                             backend=self.backend)
        if isinstance(batch, (list, tuple)):
            levels = [torch.as_tensor(np.asarray(l)).to(self.device, torch.int64)
                      for l in batch]
            return gnn.sage_forward(params, levels, self.cfg, backend=self.backend)
        raise TypeError(f"GNNModel.apply: unsupported batch type {type(batch)!r}")

    @torch.no_grad()
    def logits(self, params, hidden):
        return gnn.node_logits(params, hidden, self.cfg)


def default_frontier_cap(batch_size: int, fanouts, pad_to: int,
                         n_nodes: int) -> int:
    """Worst-case unique count of one frontier (every sampled position
    distinct, bounded by the graph), rounded up to the padding multiple."""
    worst = batch_size
    per_target = 1
    for f in fanouts:
        per_target *= f
        worst += batch_size * per_target
    cap = min(worst, int(n_nodes))
    return -(-cap // max(pad_to, 1)) * max(pad_to, 1)

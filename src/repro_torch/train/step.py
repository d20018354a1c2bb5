"""Train steps (counterpart of ``repro/train/step.py``).

``make_train_step(cfg, hyper)`` (LM) returns ``train_step(state, batch) ->
(state, metrics)``: f32 master params and Adam moments, activations in the
config's compute dtype, optional global-norm clip, the LR schedule by step
counter, and gradient accumulation over ``hyper.microbatches``.
``make_gnn_train_step(cfg, opt)`` is the node-classification step over
``GNNModel`` on a batch dict from an engine source (or the runtime's
full-graph source); with a ``"cache"`` in
the state it decodes through the hot-node cache, and with a ``mesh`` it
runs as one rank of an N-shard step.
``make_prefill_step(cfg, s_max)`` and ``make_serve_step(cfg)`` are the LM
serving steps: a prefill that fills a fresh ``LMCache`` and one decode step
against it, each returning the last position's logits, under
``torch.inference_mode()``.

The stored params never require grad.  Each step differentiates detached
views of the trainable leaves (``torch.autograd.grad``, which raises if a
trainable leaf got no gradient, so a decode path that drops the codebook
gradient cannot pass unnoticed), then updates the params in place.  The backward and the optimizer are
marked as stages for ``stages.StageTimer``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import GNNConfig, LMConfig
from repro_torch.core.backend import torch_dtype
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.lm import LMCache, init_cache, init_lm, lm_forward, lm_loss
from repro_torch.nn.module import map_tree, value_and_grad
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import linear_warmup_cosine
from repro_torch.stages import stage


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    optimizer: AdamWConfig = dataclasses.field(default_factory=lambda: AdamWConfig(
        lr=1e-3, weight_decay=0.01, clip_norm=1.0))
    warmup_steps: int = 100
    total_steps: int = 10_000
    microbatches: int = 1      # gradient accumulation (activation-memory knob)


def init_train_state(generator: torch.Generator, cfg: LMConfig, codes=None,
                     aux=None, moments_dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """``moments_dtype``: the AdamW moments' storage (bf16 in the JAX
    package's profiles of the larger archs)."""
    params = init_lm(generator, cfg, codes=codes, aux=aux)
    return {"params": params, "opt": adamw_init(params, moments_dtype), "step": 0}


def loss_and_grads(params, batch, cfg: LMConfig):
    """(loss, grads): grads has the params' structure, f32 tensors on the
    trainable leaves and None elsewhere."""
    return value_and_grad(lambda p: lm_loss(p, batch, cfg), params)


def _microbatch(batch, k: int, i: int):
    return batch if k == 1 else {n: x.chunk(k, dim=0)[i] for n, x in batch.items()}


def make_train_step(cfg: LMConfig, hyper: Optional[TrainHyper] = None) -> Callable:
    hyper = hyper or TrainHyper()
    k = max(1, hyper.microbatches)

    def train_step(state, batch):
        params = state["params"]
        # gradient accumulation over k microbatches, summed in f32, then
        # scaled by 1/k (one microbatch's activations alive at a time)
        loss, grads = loss_and_grads(params, _microbatch(batch, k, 0), cfg)
        for i in range(1, k):
            loss_i, grads_i = loss_and_grads(params, _microbatch(batch, k, i), cfg)
            loss = loss + loss_i
            grads = map_tree(lambda _, a, b: None if a is None else a + b, grads, grads_i)
        if k > 1:
            loss = loss / k
            grads = map_tree(lambda _, g: None if g is None else g * (1.0 / k), grads)
        lr_scale = linear_warmup_cosine(state["step"], hyper.warmup_steps,
                                        hyper.total_steps)
        with stage("optimizer"):
            adamw_update(params, grads, state["opt"], hyper.optimizer, lr_scale=lr_scale)
        state["step"] += 1
        return state, {"loss": loss, "lr_scale": lr_scale}

    return train_step


def init_gnn_train_state(generator: torch.Generator, cfg: GNNConfig, codes=None,
                         aux=None, params=None) -> Dict[str, Any]:
    """Train state for the graph engine (the LM state's layout, f32
    moments); ``params`` replaces the seeded init.  When the embedding
    config enables the hot-node cache (``cache_capacity > 0`` on a
    compressed kind) the state carries a ``"cache"`` ``CacheState`` on the
    params' device, in the compute dtype."""
    from repro_torch.core.backend import CacheState
    from repro_torch.models.gnn import init_gnn
    if params is None:
        params = init_gnn(generator, cfg, codes=codes, aux=aux)
    state = {"params": params, "opt": adamw_init(params), "step": 0}
    ecfg = cfg.embedding_config()
    if ecfg.is_compressed and ecfg.cache_capacity > 0:
        state["cache"] = CacheState.create(ecfg.cache_capacity, cfg.d_e,
                                           torch_dtype(cfg.compute_dtype),
                                           device=params["w1"].device)
    return state


def gnn_loss(model, params, batch, hidden: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The node-classification loss the GNN step differentiates: ``model``
    (a ``GNNModel``) over ``batch`` (a device-resident batch dict), or over
    its ``hidden`` when the caller decoded it (the cached step).  A
    full-graph batch gives hidden for ALL nodes; the loss reads its
    training nodes ``ids`` (distinct, so the gather's backward adds each row
    once)."""
    from repro_torch.graph.engine import batch_view
    from repro_torch.models import gnn
    if hidden is None:
        hidden = model.apply(params, batch_view(batch))
    with stage("logits"):
        logits = model.logits(params, hidden)
        if "ids" in batch:
            logits = logits.index_select(0, batch["ids"])
    with stage("loss"):
        return gnn.node_loss(logits, batch["labels"])


def make_gnn_train_step(cfg: GNNConfig, opt: Optional[AdamWConfig] = None,
                        device: DeviceLike = None, mesh=None,
                        duplication: Optional[float] = None) -> Callable:
    """Node-classification step on ``device``: the batch is
    {"frontier": FrontierBatch, "labels": y} (dedup decode),
    {"levels": tuple, "labels": y} (naive), on the host or already on the
    device, or the runtime's full-graph {"full": FullGraphBatch, "ids":
    train nodes, "labels": y} (GCN / SGC / GIN: logits for all nodes, the
    loss over ``ids``); the loss is ``gnn_loss``.  The decode runs on the
    backend of the config's ``lookup_impl`` and its gradient through that
    backend's backward (on the card, the ``hash_decode`` forward and
    backward kernels).  The stages ``h2d`` and ``optimizer`` are marked
    here, ``logits`` and ``loss`` in ``gnn_loss``, ``backward`` in
    ``value_and_grad``, ``unpack``, ``decode``, ``mlp`` and ``sage`` inside
    the model.

    If the state carries a ``"cache"``, the frontier decode is served
    through the hot-node cache (``GNNModel.apply_cached``: only the
    planned-miss prefix when the batch carries ``n_decode``), the new cache
    replaces the old one, its version is bumped after the optimizer step
    (which is what ages cached rows past the staleness budget), and the
    metrics carry its cumulative ``cache_hits`` and ``cache_misses``.

    ``mesh`` (a ``parallel.sharding.DataMesh``) makes the model and each
    step run under that mesh: with ``lookup_impl="sharded"``, ``"owner"``
    or ``"auto"`` a placed ``ShardedSageBatchSource`` batch decodes its
    rank's block, and the rest of the step runs on the whole batch on every
    rank, so the ranks' params stay equal bit for bit.  ``duplication``
    (``ShardedSageBatchSource.measure_duplication``) lets ``auto`` prefer
    the owner-computes decode past ``OWNER_DUP_THRESHOLD``."""
    from repro_torch.core.backend import CachedDecodeBackend
    from repro_torch.graph.engine import GNNModel, batch_to, batch_view
    from repro_torch.parallel.sharding import use_sharding
    dev = resolve_device(device)
    with use_sharding(mesh):
        model = GNNModel(cfg, dev, duplication=duplication)
    ocfg = opt or AdamWConfig(lr=1e-2, weight_decay=0.0)

    def train_step(state, batch):
        with use_sharding(mesh):
            return _train_step(state, batch)
    train_step.model = model        # the decode backend it resolved, for callers to read

    def _train_step(state, batch):
        with stage("h2d"):
            batch = batch_to(batch, dev)
        view = batch_view(batch)
        new_cache = []

        def loss_fn(p):
            h = None
            if "cache" in state:
                h, cache = model.apply_cached(p, view, state["cache"])
                new_cache.append(cache)
            return gnn_loss(model, p, batch, h)

        loss, grads = value_and_grad(loss_fn, state["params"])
        with stage("optimizer"):
            adamw_update(state["params"], grads, state["opt"], ocfg)
        state["step"] += 1
        metrics = {"loss": loss}
        if new_cache:
            state["cache"] = CachedDecodeBackend.bump_version(new_cache[0])
            metrics["cache_hits"] = state["cache"].hits
            metrics["cache_misses"] = state["cache"].misses
        return state, metrics

    return train_step


def make_prefill_step(cfg: LMConfig, s_max: int) -> Callable:
    """(params, {"tokens": (B, S0)[, "positions"]}) -> (last logits (B, Vpad),
    cache): a fresh cache of ``s_max`` slots in the compute dtype, on the
    tokens' device, filled with the prompt."""
    def prefill_step(params, batch):
        tokens = batch["tokens"]
        with torch.inference_mode():
            cache = init_cache(cfg, tokens.shape[0], s_max, torch_dtype(cfg.compute_dtype),
                               device=tokens.device)
            logits, cache = lm_forward(params, tokens, cfg, cache=cache,
                                       positions=batch.get("positions"))
            return logits[:, -1], cache
    return prefill_step


def make_serve_step(cfg: LMConfig) -> Callable:
    """(params, cache, {"tokens": (B, 1)[, "positions"]}) -> (logits (B, Vpad),
    cache): one decode step; the cache's buffers are written in place."""
    def serve_step(params, cache: LMCache, batch):
        with torch.inference_mode():
            logits, cache = lm_forward(params, batch["tokens"], cfg, cache=cache,
                                       positions=batch.get("positions"))
            return logits[:, -1], cache
    return serve_step

"""GraphRuntime: one declarative spec -> train / evaluate / embed / serve;
counterpart of ``repro/graph/runtime.py``.

    spec = RuntimeSpec(graph=GraphSource(n_nodes=20_000),
                       model=paper_gnn_config("sage", n_nodes=20_000))
    rt = GraphRuntime.from_spec(spec)            # on the CUDA device
    rt.train()                                   # spec.total_steps steps
    rt.evaluate("val")                           # {"accuracy", "loss", "n"}
    engine = rt.serve()                          # GraphInferenceEngine, cached
    tier = rt.serve(batching=BatchingSpec())     # ServingBatcher around it
    rt = GraphRuntime.resume(spec.ckpt_dir)      # from the newest checkpoint

``RuntimeSpec`` has every field of the JAX package's spec, so a JAX
``RuntimeSpec.to_json()`` loads here unchanged (``from_json``) and
round-trips.  What the port runs on one device: minibatched GraphSAGE,
with the hot-node decode cache (``cache_capacity`` / ``cache_staleness``
/ ``cache_plan_misses`` in training, on by default in serving) and the
continuous-batching tier (``batching``) as spec field changes, as in the
JAX package; and the full-graph GCN / SGC / GIN (``model``), which train,
evaluate and embed in one pass over all nodes with the normalised
adjacency uploaded once (``FullGraphSource``; no sampler, no prefetch,
no serving).  ``codes_placement="host"`` keeps the packed codes in host
RAM as the JAX package does: the params carry no ``codes_buf``, and every
frontier of training, evaluation and serving takes its code rows from the
runtime's numpy buffer (``codes``) on the host.  ``n_shards=N`` trains
GraphSAGE as one of N ranks of a ``torch.distributed`` group (the same
program on every rank, as ``parallel.sharding`` describes): the mesh, the
frontier placement, a ``ShardedSageBatchSource`` and, for ``owner`` or a
measured ``auto``, the owner plan; evaluation, embedding and serving run
whole on every rank, and rank 0 writes the checkpoints every rank
restores.  ``rescale`` and ``rescale_checkpoint`` continue a run at another
shard count bit for bit (``repro_torch.elastic``), and
``elastic.ElasticManager`` recovers a run from a dead rank's peers.

Graph, splits and batches are pure functions of the spec's seeds (numpy,
identical to the JAX package's); the LSH projections and weights come from
a ``torch.Generator`` seeded with ``init_seed`` on the runtime's device.
Parity with a JAX-built runtime goes through ``params=``
(``repro_torch.interop.params_from_jax``), and under host placement,
whose params carry no codes, the JAX runtime's buffer through ``codes=``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import EmbeddingSpec, GNNConfig
from repro_torch.device import DeviceLike, make_generator, resolve_device
from repro_torch.elastic.manager import ElasticSpec
from repro_torch.graph.engine import (FullGraphBatch, GNNModel, MissPlanningSource,
                                      PrefetchIterator, SageBatchSource,
                                      ShardedSageBatchSource, _step_rng)
from repro_torch.graph.generate import train_val_test_split
from repro_torch.graph.sampler import NeighborSampler, attach_codes
from repro_torch.nn.module import map_tree
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serving.batcher import BatchingSpec

FULLGRAPH_MODELS = ("gcn", "sgc", "gin")


@dataclasses.dataclass(frozen=True)
class GraphSource:
    """Declarative graph descriptor (the generators are deterministic in
    their seed, so the descriptor IS the dataset)."""

    kind: str = "powerlaw"        # powerlaw | sbm | external
    seed: int = 0
    n_nodes: int = 10_000
    n_classes: int = 16
    avg_degree: int = 10          # powerlaw only
    homophily: float = 0.85       # powerlaw only
    p_in: float = 0.02            # sbm only
    p_out: float = 0.002          # sbm only

    def build(self):
        from repro_torch.graph.generate import powerlaw_graph, sbm_graph
        if self.kind == "powerlaw":
            return powerlaw_graph(self.seed, self.n_nodes,
                                  avg_degree=self.avg_degree,
                                  n_classes=self.n_classes,
                                  homophily=self.homophily)
        if self.kind == "sbm":
            return sbm_graph(self.seed, self.n_nodes, self.n_classes,
                             p_in=self.p_in, p_out=self.p_out)
        if self.kind == "external":
            raise ValueError(
                "GraphSource(kind='external') has no generator — pass the "
                "graph to GraphRuntime.from_spec(spec, graph=(adj, labels))")
        raise ValueError(f"unknown graph kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class RuntimeSpec:
    """Everything needed to build the pipeline; the JAX package's fields,
    names and defaults."""

    graph: GraphSource
    model: GNNConfig
    optimizer: AdamWConfig = dataclasses.field(
        default_factory=lambda: AdamWConfig(lr=1e-2, weight_decay=0.0))
    # -- data pipeline --
    batch_size: int = 256
    data_seed: int = 0
    max_deg: int = 64
    pad_to: int = 256
    frontier_cap: Optional[int] = None
    dedup: bool = True
    prefetch_depth: int = 2
    n_shards: int = 1
    owner_cap: Optional[int] = None
    owner_unique_cap: Optional[int] = None
    # -- init / splits --
    init_seed: int = 0
    split_seed: int = 0
    split_frac: Tuple[float, float, float] = (0.7, 0.1, 0.2)
    # -- loop --
    total_steps: int = 300
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    log_every: int = 25
    # -- eval / serve --
    eval_batch: int = 512
    eval_seed: int = 17
    serve_batch: int = 256
    batching: Optional[BatchingSpec] = None
    elastic: Optional[ElasticSpec] = None
    # Pallas interpret mode of the JAX package; the port has no Pallas and
    # ignores it (the device decides between kernel and plain version).
    interpret: Optional[bool] = None

    def with_updates(self, **kw) -> "RuntimeSpec":
        """Replace fields across the nesting in one call: RuntimeSpec fields
        first, then ``EmbeddingSpec`` fields, then ``GNNConfig`` fields, as
        the JAX package's: ``spec.with_updates(lookup_impl="tt",
        tt_rank=8)``, ``spec.with_updates(quantize="int8")``."""
        groups = [{f.name for f in dataclasses.fields(cls)}
                  for cls in (RuntimeSpec, EmbeddingSpec, GNNConfig)]
        spec_kw, emb_kw, model_kw = {}, {}, {}
        for k, v in kw.items():
            for names, out in zip(groups, (spec_kw, emb_kw, model_kw)):
                if k in names:
                    out[k] = v
                    break
            else:
                raise TypeError(f"with_updates: unknown field {k!r}")
        model = spec_kw.pop("model", self.model)
        if emb_kw:
            model = dataclasses.replace(
                model, embedding=dataclasses.replace(model.embedding, **emb_kw))
        if model_kw:
            model = dataclasses.replace(model, **model_kw)
        return dataclasses.replace(self, model=model, **spec_kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RuntimeSpec":
        d = dict(d)
        graph = GraphSource(**d.pop("graph"))
        md = dict(d.pop("model"))
        md["embedding"] = EmbeddingSpec(**md["embedding"])
        md["fanouts"] = tuple(md["fanouts"])
        model = GNNConfig(**md)
        opt = AdamWConfig(**d.pop("optimizer"))
        d["split_frac"] = tuple(d["split_frac"])
        if d.get("batching") is not None:
            d["batching"] = BatchingSpec(**d["batching"])
        if d.get("elastic") is not None:
            d["elastic"] = ElasticSpec(**d["elastic"])
        return cls(graph=graph, model=model, optimizer=opt, **d)

    @classmethod
    def from_json(cls, s: str) -> "RuntimeSpec":
        return cls.from_dict(json.loads(s))


def _chain(fns, batch):
    for fn in fns:
        batch = fn(batch)
    return batch


class FullGraphSource:
    """Batch source for GCN / SGC / GIN (the paper trains them without
    minibatches, §C.1): every step is the same full-graph handle plus the
    training nodes' ids and labels, all on the device once, so a step
    copies nothing from the host.  Its state is the step count."""

    def __init__(self, full: FullGraphBatch, nodes: np.ndarray, labels: np.ndarray):
        dev = full.adj.device
        nodes = np.asarray(nodes)
        self._batch = {"full": full,
                       "ids": torch.from_numpy(nodes.astype(np.int64)).to(dev),
                       "labels": torch.from_numpy(
                           np.asarray(labels)[nodes].astype(np.int64)).to(dev)}
        self.step = 0

    def next_batch(self) -> Dict[str, Any]:
        self.step += 1
        return self._batch

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.step = int(state["step"])


class GraphRuntime:
    """Build once from a spec, then ``train`` / ``evaluate`` / ``embed`` /
    ``serve`` on one device.

    Construction wires graph -> codes -> train state -> splits -> train
    step -> checkpoint manager -> sampler -> batch source -> (prefetching)
    iterator the way the JAX runtime does; a full-graph model takes the
    normalised adjacency, uploaded once, and a ``FullGraphSource`` in place
    of the last three.  ``state`` (params, optimizer,
    step), ``data_iter`` and ``train_step`` are exposed for callers that
    drive steps themselves.  Under ``codes_placement="host"`` the numpy
    uint32 buffer ``codes`` is the codes' only copy, and a code gather
    (``attach_codes``) runs in the prefetch producer, or before each step
    without prefetch."""

    def __init__(self, spec: RuntimeSpec, *, adj, labels, device: torch.device,
                 params=None, codes=None, group=None):
        cfg = spec.model
        ecfg = cfg.embedding_config()
        self.fullgraph = cfg.model in FULLGRAPH_MODELS
        self.codes_on_host = ecfg.codes_on_host
        if self.fullgraph and self.codes_on_host:
            raise ValueError(
                "codes_placement='host' needs the sampled (frontier) model "
                "family — full-graph models decode every node per step, so "
                "there is no O(frontier) working set to stream")
        self.spec = spec
        if spec.graph.kind != "external" and cfg.n_nodes != spec.graph.n_nodes:
            raise ValueError(f"model.n_nodes {cfg.n_nodes} != graph.n_nodes "
                             f"{spec.graph.n_nodes}")
        if adj.shape[0] != cfg.n_nodes:
            raise ValueError(f"graph has {adj.shape[0]} nodes, model expects {cfg.n_nodes}")
        self.adj = adj
        self.labels = np.asarray(labels)
        self.cfg = cfg
        # -- mesh / placement (n_shards is the whole N-shard switch) -------
        self.mesh = self.place = None
        if spec.n_shards > 1:
            from repro_torch.parallel.policy import make_frontier_placement
            from repro_torch.parallel.sharding import data_mesh
            self.mesh = data_mesh(spec.n_shards, device=device, group=group)
            device = self.mesh.device
            self.place = make_frontier_placement(self.mesh)
        self.device = device
        self.model = GNNModel(cfg, device)
        if codes is not None and not self.codes_on_host:
            raise ValueError("codes= is the host buffer of codes_placement='host'; "
                             "device-placed codes ride in the params")
        if params is None or (self.codes_on_host and codes is None):
            from repro_torch.core import embedding as emb_lib
            gen = make_generator(spec.init_seed, device)
            # the codes come first from the seeded generator, so a host
            # buffer drawn beside given params is the seeded init's; hashemb
            # stores no codes: it hashes the ids at every lookup
            if codes is None and ecfg.needs_codes:
                codes = emb_lib.make_codes(gen, ecfg, aux=adj)
            if params is None:
                params = self.model.init(gen, codes=codes)
        self.host_codes = None
        self._to_device = lambda b: b
        if self.codes_on_host:
            from repro_torch.core.codes import n_words, to_uint32
            # the authoritative buffer: numpy uint32 words, the JAX layout
            self.host_codes = np.ascontiguousarray(
                to_uint32(codes) if isinstance(codes, torch.Tensor) else codes, np.uint32)
            want = (cfg.n_nodes, n_words(ecfg.c, ecfg.m))
            if self.host_codes.shape != want:
                raise ValueError(f"codes shape {self.host_codes.shape} != {want}")
        from repro_torch.train.step import init_gnn_train_state, make_gnn_train_step
        self.state = init_gnn_train_state(None, cfg, params=params)

        tr, va, te = train_val_test_split(spec.split_seed, cfg.n_nodes, spec.split_frac)
        self.splits = {"train": tr, "val": va, "test": te}
        self.ckpt = None
        if spec.ckpt_dir:
            from repro_torch.train.checkpoint import CheckpointManager
            self.ckpt = CheckpointManager(spec.ckpt_dir, keep=2, mesh=self.mesh)
        if self.fullgraph:
            self.train_step = make_gnn_train_step(cfg, spec.optimizer, device, mesh=self.mesh)
            # no neighbour table (full-graph models never sample) and no
            # prefetch (the one batch is on the device already)
            self.sampler = None
            self.adj_norm = adj.with_self_loops().normalized("sym")
            self.full = FullGraphBatch(self.adj_norm.on(device))
            self.source = self.data_iter = FullGraphSource(self.full, tr, self.labels)
            return
        self.adj_norm = self.full = None
        self.sampler = NeighborSampler(adj, cfg.fanouts, max_deg=spec.max_deg,
                                       seed=spec.data_seed)
        if spec.n_shards > 1:
            if spec.batch_size % spec.n_shards:
                raise ValueError(f"batch_size {spec.batch_size} not divisible by "
                                 f"n_shards {spec.n_shards}")
            # the owner-computes decode: the source plans the exchange
            # whenever the backend can use it, always for "owner[:base]",
            # past the measured duplication threshold for "auto"
            impl = (cfg.embedding.lookup_impl or "auto").split(":")[0]
            self.source = ShardedSageBatchSource(
                self.sampler, tr, self.labels, spec.batch_size // spec.n_shards,
                n_shards=spec.n_shards, seed=spec.data_seed, pad_to=spec.pad_to,
                frontier_cap=spec.frontier_cap,
                owner_plan={"owner": True, "auto": "auto"}.get(impl, False),
                owner_cap=spec.owner_cap, owner_unique_cap=spec.owner_unique_cap)
        else:
            self.source = SageBatchSource(self.sampler, tr, self.labels, spec.batch_size,
                                          seed=spec.data_seed, dedup=spec.dedup,
                                          pad_to=spec.pad_to, frontier_cap=spec.frontier_cap)
        self.train_step = make_gnn_train_step(
            cfg, spec.optimizer, device, mesh=self.mesh,
            duplication=getattr(self.source, "duplication_measured", None))
        emb = cfg.embedding
        if emb.cache_plan_misses:
            # plan-ahead miss partition: the producer permutes the next
            # frontier miss-first against a host replica of the cache, so
            # the step decodes only the (predicted) misses
            if emb.cache_capacity <= 0 or not cfg.embedding_config().is_compressed:
                raise ValueError("cache_plan_misses needs a hot-node cache on a "
                                 "compressed embedding (cache_capacity > 0)")
            if spec.n_shards > 1 or not spec.dedup:
                raise ValueError("cache_plan_misses is single-shard dedup only: the "
                                 "miss-first permutation needs the dedup frontier")
            self.source = MissPlanningSource(self.source, emb.cache_capacity,
                                             emb.cache_staleness, pad_to=spec.pad_to)
        # prefetch is a knob, not a code path: the step takes host or
        # device batches alike.  Host codes: the producer attaches a batch's
        # rows, or without prefetch the loop does before each step
        gather = self._attach if self.codes_on_host else None
        self.data_iter = (PrefetchIterator(self.source, depth=spec.prefetch_depth,
                                           device=self.place or device, code_gather=gather)
                          if spec.prefetch_depth > 0 else self.source)
        if spec.prefetch_depth <= 0:
            # without prefetch the loop places (and gathers codes) itself
            steps = [f for f in (getattr(self.place, "select", None), gather) if f]
            if steps:
                self._to_device = lambda b: _chain(steps, b)

    def _attach(self, batch):
        """A batch with its frontier's packed code rows from the host buffer."""
        if isinstance(batch, dict) and "frontier" in batch:
            batch = dict(batch, frontier=attach_codes(batch["frontier"], self.host_codes))
        return batch

    def _frontier(self, ids: np.ndarray, rng: np.random.Generator):
        """An evaluation frontier of ``ids``, with its code rows under host
        placement."""
        fb = self.sampler.sample_frontier(ids, pad_to=self.spec.pad_to, rng=rng)
        return attach_codes(fb, self.host_codes) if self.codes_on_host else fb

    # -- construction ----------------------------------------------------
    @classmethod
    def from_spec(cls, spec: RuntimeSpec,
                  graph: Optional[Tuple[Any, np.ndarray]] = None,
                  device: DeviceLike = None, params=None, codes=None,
                  group=None) -> "GraphRuntime":
        """Build the pipeline from a spec on ``device`` (default: the CUDA
        card; raises without one unless ``device="cpu"``).  ``graph``
        overrides the spec's generator with a pre-built ``(adj, labels)``;
        ``params`` replaces the seeded init (e.g. JAX params through
        ``interop.params_from_jax``).  ``codes`` (``codes_placement="host"``
        only) is the packed uint32 buffer, (n_nodes, n_words), in place of
        encoding the graph: JAX's host-placed params carry no codes, and
        its buffer is ``GraphRuntime.codes`` there.  ``group``: the process
        group of an ``n_shards`` run (default: the whole world; a subgroup
        from ``parallel.sharding.group_mesh``)."""
        device = resolve_device(device)
        adj, labels = spec.graph.build() if graph is None else graph
        return cls(spec, adj=adj, labels=labels, device=device, params=params, codes=codes,
                   group=group)

    @classmethod
    def resume(cls, ckpt_dir: str, graph: Optional[Tuple[Any, np.ndarray]] = None,
               device: DeviceLike = None, group=None) -> "GraphRuntime":
        """Rebuild a runtime from the spec in ``ckpt_dir``'s newest
        checkpoint and restore its params, optimizer and data state, so
        ``evaluate`` / ``embed`` / ``serve`` see the trained model and a
        later ``train`` continues the exact step sequence.  The spec keeps
        the codes' placement; host codes are drawn again from its seed."""
        from repro_torch.train.checkpoint import CheckpointManager
        extra = CheckpointManager(ckpt_dir).read_extra()
        if extra is None or "spec" not in extra:
            raise FileNotFoundError(f"no checkpoint with a runtime spec under {ckpt_dir!r}")
        spec = dataclasses.replace(RuntimeSpec.from_dict(extra["spec"]), ckpt_dir=ckpt_dir)
        rt = cls.from_spec(spec, graph=graph, device=device, group=group)
        restored = rt.ckpt.restore_latest(rt.state)
        if restored is not None:
            _step, rt.state, rextra = restored
            if "data" in rextra:
                rt.data_iter.load_state_dict(rextra["data"])
            # miss-planning runs: re-anchor the host cache shadow to the
            # restored device cache (exact even without a shadow snapshot)
            src = getattr(rt.data_iter, "source", rt.data_iter)
            if hasattr(src, "sync_shadow") and "cache" in rt.state:
                src.sync_shadow(rt.state["cache"])
        return rt

    # -- training --------------------------------------------------------
    @property
    def params(self):
        return self.state["params"]

    @property
    def codes(self):
        """The packed code buffer: the params' ``codes_buf`` (int64 words on
        the device), under ``codes_placement="host"`` the numpy uint32
        buffer on the host; None for dense kinds and the hashemb family."""
        if self.codes_on_host:
            return self.host_codes
        return self.params["embed"].get("codes_buf")

    def train(self, steps: Optional[int] = None,
              on_metrics: Optional[Callable[[int, Dict], None]] = None,
              fence: Optional[Callable[[int], None]] = None):
        """Run the loop for ``steps`` (default ``spec.total_steps``) and keep
        the resulting state; returns the ``LoopResult``.  With
        ``spec.ckpt_dir`` set, ``steps`` is the absolute target: the loop
        resumes from the newest checkpoint (params, optimizer, data state;
        every manifest carries the spec and the shard topology) and trains
        the gap.  ``fence``: the loop's step-fence callback."""
        from repro_torch.train.loop import LoopConfig, run_training
        spec = self.spec
        total = int(steps if steps is not None else spec.total_steps)
        res = run_training(
            self.train_step, self.state, self.data_iter,
            LoopConfig(total_steps=total, ckpt_every=spec.ckpt_every,
                       log_every=spec.log_every),
            ckpt=self.ckpt, to_device=self._to_device, on_metrics=on_metrics,
            extra_base={"spec": spec.to_dict()}, fence=fence,
            topology={"n_shards": spec.n_shards, "batch_size": spec.batch_size})
        self.state = res.state
        return res

    # -- elastic rescale -------------------------------------------------
    def rescale(self, n_shards: int, ckpt_dir: Optional[str] = None
                ) -> Optional["GraphRuntime"]:
        """Exact in-process rescale: a new runtime at ``n_shards`` that
        continues this run's state and batch stream bit for bit as a native
        ``n_shards`` run would (``repro_torch.elastic.rescale``; the global
        ``batch_size`` must divide by it).  Every rank of the world calls
        it; a rank outside the new group gets ``None``.  This runtime stays
        usable: close it when done.  ``ckpt_dir`` names a new checkpoint
        directory for the rescaled run (the old one carries the old
        topology)."""
        from repro_torch.elastic.rescale import rescale_runtime
        return rescale_runtime(self, n_shards, ckpt_dir=ckpt_dir)

    @classmethod
    def rescale_checkpoint(cls, ckpt_dir: str, n_shards: int,
                           graph: Optional[Tuple[Any, np.ndarray]] = None,
                           new_ckpt_dir: Optional[str] = None,
                           device: DeviceLike = None) -> Optional["GraphRuntime"]:
        """Resume across topologies, the path ``TopologyMismatch`` names:
        resume the checkpoint at its own shard count on the world's first
        that many ranks (the topology check passes by construction), then
        rescale exactly to ``n_shards``.  Every rank of the world calls it
        (ranks outside the checkpoint's group join a grow); a rank outside
        the new group gets ``None``."""
        from repro_torch.elastic.rescale import rescale_runtime
        from repro_torch.parallel.sharding import distributed, group_mesh
        from repro_torch.train.checkpoint import CheckpointManager
        extra = CheckpointManager(ckpt_dir).read_extra()
        if extra is None or "spec" not in extra:
            raise FileNotFoundError(f"no checkpoint with a runtime spec under {ckpt_dir!r}")
        group = None
        if distributed():
            mesh = group_mesh(range(int(extra["spec"]["n_shards"])), device=device)
            if mesh is None:
                return rescale_runtime(None, n_shards, ckpt_dir=new_ckpt_dir, graph=graph,
                                       device=device)
            group = mesh.group
        rt = cls.resume(ckpt_dir, graph=graph, device=device, group=group)
        try:
            return rescale_runtime(rt, n_shards, ckpt_dir=new_ckpt_dir)
        finally:
            rt.close()

    # -- evaluation ------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, split: str = "val",
                 batch_size: Optional[int] = None) -> Dict[str, float]:
        """Accuracy and loss over a named split ("train" / "val" / "test").
        GraphSAGE evaluates in minibatches of ``eval_batch`` frontiers,
        neighbours drawn from ``(eval_seed, batch index)`` so repeat calls
        agree; the short last batch is padded and the padding masked, so
        every split node counts once.  Full-graph models evaluate in one
        pass over all nodes and read the split's rows."""
        from repro_torch.models import gnn
        nodes = self.splits[split]
        params = self.params
        if self.fullgraph:
            logits = self.model.logits(params, self.model.apply(params, self.full))
            logits = logits[torch.from_numpy(nodes).to(self.device)].float().cpu()
            labels = torch.from_numpy(self.labels[nodes].astype(np.int64))
            return {"accuracy": float(np.mean((logits.argmax(-1) == labels).numpy())),
                    "loss": float(gnn.node_loss(logits, labels)), "n": int(len(nodes))}
        bs = int(batch_size or self.spec.eval_batch)
        correct, loss_sum, seen = 0, 0.0, 0
        for bi, s in enumerate(range(0, len(nodes), bs)):
            batch = np.asarray(nodes[s:s + bs])
            n_real = batch.shape[0]
            if n_real < bs:                      # pad (masked out below)
                batch = np.concatenate([batch, np.full(bs - n_real, batch[0], batch.dtype)])
            fb = self._frontier(batch.astype(np.int32), _step_rng(self.spec.eval_seed, bi))
            logits = self.model.logits(params, self.model.apply(params, fb))
            logits = logits[:n_real].float().cpu()
            labels = torch.from_numpy(self.labels[batch[:n_real]].astype(np.int64))
            correct += int((logits.argmax(-1) == labels).sum())
            loss_sum += float(gnn.node_loss(logits, labels)) * n_real
            seen += n_real
        return {"accuracy": correct / max(seen, 1), "loss": loss_sum / max(seen, 1),
                "n": seen}

    # -- inference -------------------------------------------------------
    @torch.no_grad()
    def embed(self, node_ids) -> np.ndarray:
        """Final hidden representations (B, H) for ``node_ids`` through the
        current params (neighbour draws seeded by ``eval_seed``; full-graph
        models: the rows of one pass over all nodes)."""
        ids = np.asarray(node_ids, np.int32)
        if self.fullgraph:
            h = self.model.apply(self.params, self.full)
            return h[torch.from_numpy(ids.astype(np.int64)).to(self.device)].cpu().numpy()
        fb = self._frontier(ids, np.random.default_rng(self.spec.eval_seed))
        return self.model.apply(self.params, fb).cpu().numpy()

    def serve(self, *, batching=None, **overrides):
        """Freeze a copy of the current params into a
        ``GraphInferenceEngine`` on the runtime's device (later training
        does not move it): batched frontier sampling and, by default, the
        miss-only hot-node cached decode.  Keyword overrides go to the
        engine constructor (``cache_capacity=0`` turns the cache off).

        ``batching`` selects the continuous-batching tier
        (``serving.batcher.ServingBatcher``): ``None`` defers to
        ``spec.batching``; a ``BatchingSpec`` (or ``True`` for the
        defaults) wraps the engine in a batcher whose microbatches get
        cross-request frontier dedup; ``False`` forces the bare engine.
        The batcher owns the engine: ``close()`` it (or use it as a
        context manager) when done."""
        if self.fullgraph:
            raise NotImplementedError(
                "serving is minibatched GraphSAGE only; full-graph models "
                "evaluate via runtime.evaluate()")
        from repro_torch.serving.gnn import GraphInferenceEngine
        if batching is None:
            batching = self.spec.batching
        if batching is True:
            batching = BatchingSpec()
        kw = dict(serve_batch=self.spec.serve_batch, pad_to=self.spec.pad_to,
                  device=self.device)
        if self.codes_on_host:
            # the engine gathers each serving frontier's rows from the buffer
            kw.setdefault("host_codes", self.host_codes)
        if batching:
            # the engine's request-count buckets must admit the batcher's flushes
            kw.setdefault("max_coalesce", batching.max_batch)
        kw.update(overrides)
        frozen = map_tree(lambda _, t: t.clone(), self.params)
        engine = GraphInferenceEngine(self.cfg, frozen, self.sampler, **kw)
        if not batching:
            return engine
        from repro_torch.serving.batcher import ServingBatcher
        return ServingBatcher(engine, batching)

    def close(self) -> None:
        if hasattr(self.data_iter, "close"):
            self.data_iter.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

"""Adapter for the full-graph GNN configurations: ``repro_torch``'s
``GraphRuntime`` with the paper's GCN (§5.2, §C.1), every node decoded
every step.

The benchmark makes the inputs from the seed: the graph
(``perfbench.graphgen``), the labels, the LSH projections and the
weights.  The program makes the rest in set-up: the adjacency in its CSR
form, the codes (Algorithm 1 through ``core.embedding.make_codes``), the
normalised adjacency on the device, the split.  The window's entry is
``GraphRuntime.train``, steps back to back; set-up drives the same
runtime through its first ``checked_steps`` steps, which the reference
follows.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional

import torch

from perfbench import graphgen, inputs
from perfbench.compare import codes_gap, compare_train
from perfbench.reference import fullgraph_gnn as ref


def _weight_specs(cfg: dict) -> List[inputs.Spec]:
    e = cfg["embedding"]
    dims = [e["d_c"]] + [e["d_m"]] * (e["n_layers"] - 1) + [cfg["d_e"]]
    specs = [("codebooks", (e["m"], e["c"], e["d_c"]), 1.0 / math.sqrt(e["m"]))]
    for i in range(e["n_layers"]):
        specs += [(f"dec.w{i}", (dims[i], dims[i + 1]), 1.0 / math.sqrt(dims[i])),
                  (f"dec.b{i}", (dims[i + 1],), 0.0)]
    H = cfg["hidden"]
    return specs + [("gcn.w1", (cfg["d_e"], H), 1.0 / math.sqrt(cfg["d_e"])),
                    ("gcn.b1", (H,), 0.0),
                    ("gcn.w2", (H, H), 1.0 / math.sqrt(H)), ("gcn.b2", (H,), 0.0),
                    ("out.w", (H, cfg["n_classes"]), cfg["output_scale"] / math.sqrt(H)),
                    ("out.b", (cfg["n_classes"],), 0.0)]


def _port_path(name: str) -> tuple:
    """The program's parameter path of a benchmark weight."""
    if name == "codebooks":
        return ("embed", "decoder", "codebooks")
    group, leaf = name.split(".")
    if group == "dec":
        return ("embed", "decoder", "mlp", leaf)
    return (leaf,) if group == "gcn" else (f"{leaf}_out",)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


class System:
    """One cell of a full-graph configuration.  ``after_build`` holds
    callbacks that get the system once the runtime exists and before its
    first step (the fault tests plant faults there)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.mode = traffic["mode"]
        if self.mode != "train":
            raise ValueError(f"unknown traffic mode {self.mode!r}")
        self.seeds = dict(zip(("graph", "lsh", "weights", "split"), inputs.derived_seeds(seed, 4)))
        self.after_build: List[Callable[["System"], None]] = []
        self.rt = None
        self.observed: dict = {}
        self.window_losses: List[float] = []
        self.log: Callable[[str], None] = lambda msg: None
        self._t = time.perf_counter()

    def _phase(self, name: str) -> None:
        now = time.perf_counter()
        self.log(f"[setup] {name} {now - self._t:.3f} s")
        self._t = now

    # -- set-up ----------------------------------------------------------
    def make_inputs(self) -> None:
        """The benchmark's inputs from the seed: edges, labels, the LSH
        projections and the weights (on the device)."""
        cfg, e = self.config, self.config["embedding"]
        n, g = cfg["n_nodes"], cfg["graph"]
        src, dst, labels = graphgen.relabelled(*graphgen.powerlaw_edges(
            g["structure_seed"], n, cfg["n_edges"], cfg["n_classes"], g["homophily"],
            g["degree_exponent"]), self.seeds["graph"])
        self.edges = (src, dst)
        self.labels = labels
        n_bits = e["m"] * (int(e["c"]).bit_length() - 1)
        V = inputs.draw([("V", (n, n_bits), 1.0)], self.seeds["lsh"], self.device)["V"]
        # Gaussian directions on a grid of 1/16 within +-8: every sum A V
        # of a row of up to 2**24 / 128 neighbours is exact in float32 in
        # any order, so the program's codes and the reference's cannot
        # differ by a rounding at the median
        self.V = torch.clamp(torch.round(V * 16.0), -128, 128) / 16.0
        self.w0 = inputs.draw(_weight_specs(cfg), self.seeds["weights"], self.device)

    def setup(self) -> None:
        from repro_torch.configs.base import EmbeddingSpec, GNNConfig
        from repro_torch.core import codes as codes_lib
        from repro_torch.core import embedding as emb_lib
        from repro_torch.graph.csr import CSRMatrix
        from repro_torch.graph.runtime import GraphRuntime, GraphSource, RuntimeSpec
        from repro_torch.optim.adamw import AdamWConfig
        cfg, e = self.config, self.config["embedding"]
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False     # the configuration's float32
        self._t = time.perf_counter()
        self.make_inputs()
        self._phase("inputs (graph, projections, weights)")
        n, (src, dst), labels = cfg["n_nodes"], self.edges, self.labels

        gcfg = GNNConfig(name=cfg["name"], model=cfg["model"], n_nodes=n,
                         n_classes=cfg["n_classes"], d_e=cfg["d_e"], hidden=cfg["hidden"],
                         n_gnn_layers=cfg["n_gnn_layers"], task="node",
                         embedding=EmbeddingSpec(kind=e["kind"], c=e["c"], m=e["m"],
                                                 d_c=e["d_c"], d_m=e["d_m"],
                                                 n_layers=e["n_layers"],
                                                 lookup_impl=e["lookup_impl"]),
                         compute_dtype=cfg["compute_dtype"])
        adj = CSRMatrix.from_edges(src, dst, n)
        blocks = list(self.V.split(codes_lib.WORD_BITS, dim=1))
        self._phase("the program's CSR adjacency")
        codes = emb_lib.make_codes(None, gcfg.embedding_config(), aux=adj, projections=blocks)
        self._phase("Algorithm 1 (make_codes)")
        params = {"embed": {"codes_buf": codes_lib.from_uint32(codes).to(self.device),
                            "decoder": {"mlp": {}}}}
        for name, w in self.w0.items():
            path = _port_path(name)
            parent = params
            for k in path[:-1]:
                parent = parent.setdefault(k, {})
            parent[path[-1]] = w.clone()
        o = cfg["optimizer"]
        spec = RuntimeSpec(graph=GraphSource(kind="external", n_nodes=n,
                                             n_classes=cfg["n_classes"]),
                           model=gcfg, optimizer=AdamWConfig(**o),
                           split_seed=self.seeds["split"], split_frac=tuple(cfg["split_frac"]),
                           log_every=1, ckpt_dir=None)
        self.rt = GraphRuntime.from_spec(spec, graph=(adj, labels), device=self.device,
                                         params=params)
        unpacked = codes_lib.unpack_codes(params["embed"]["codes_buf"], e["c"], e["m"])
        offsets = torch.arange(e["m"], device=self.device) * e["c"]
        self.named_rows = int(torch.unique(unpacked.long() + offsets).numel())
        self._phase("GraphRuntime.from_spec")
        for hook in self.after_build:
            hook(self)
        self._checked_steps()
        self._phase("first train units")

    def _checked_steps(self) -> None:
        """The runtime's first steps through its own ``train``: each loss,
        the first gradient from the moments after step 1 (mu / (1 - b1)),
        and every leaf's change after the last checked step."""
        rt, steps = self.rt, self.traffic["checked_steps"]
        b1 = self.config["optimizer"]["b1"]
        obs = {"grad_norms": {}, "delta_norms": {}}

        def record(step, _metrics):
            if step == 0:
                obs["grad_norms"] = {k: _norm(_at(rt.state["opt"]["mu"], _port_path(k)) / (1 - b1))
                                     for k in self.w0}
            if step == steps - 1:
                obs["delta_norms"] = {k: _norm(_at(rt.params, _port_path(k)) - w)
                                      for k, w in self.w0.items()}

        res = rt.train(steps, on_metrics=record)
        obs["losses"] = list(res.losses)
        self.observed = obs

    # -- the window ------------------------------------------------------
    def window(self, until: float) -> int:
        """Steps run back to back until the host clock passes ``until``;
        the last one ends synchronised."""
        from repro_torch.train.loop import FenceInterrupt

        def fence(_step):
            if time.perf_counter() >= until:
                raise FenceInterrupt

        res = self.rt.train(1 << 40, fence=fence)
        self.window_losses += res.losses
        return len(res.losses)

    def work(self) -> Dict[str, List[dict]]:
        """The kernel calls of one step, with the shapes their work is
        counted from."""
        e = self.config["embedding"]
        call = dict(rows=self.config["n_nodes"], m=e["m"], c=e["c"], d_c=e["d_c"],
                    elem=4, named=self.named_rows)
        return {"hash_decode": [call], "hash_decode_bwd": [call]}

    @property
    def attempted(self) -> int:
        return len(self.window_losses)

    @property
    def failed(self) -> int:
        return sum(not math.isfinite(x) for x in self.window_losses)

    # -- correctness -----------------------------------------------------
    def release(self) -> None:
        """Keep the codes the program trained with, then drop its state so
        the reference has the card."""
        if self.rt is not None:
            from repro_torch.core import codes as codes_lib
            e = self.config["embedding"]
            self.program_codes = codes_lib.unpack_codes(
                self.rt.params["embed"]["codes_buf"], e["c"], e["m"]).cpu()
            self.rt.close()
        self.rt = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, mm: Callable = ref.exact_mm) -> dict:
        """The reference's readings of this cell from the same inputs."""
        cfg, e = self.config, self.config["embedding"]
        n = cfg["n_nodes"]
        src = torch.from_numpy(self.edges[0]).to(self.device)
        dst = torch.from_numpy(self.edges[1]).to(self.device)
        codes = self.ref_codes = ref.lsh_codes(src, dst, n, self.V, e["c"], e["m"])
        adj = ref.gcn_adjacency(src, dst, n)
        labels = torch.from_numpy(self.labels).to(self.device)
        ids = torch.from_numpy(ref.split(self.seeds["split"], n, cfg["split_frac"])[0])
        return ref.train(self.w0, codes, adj, ids.to(self.device), labels, e["n_layers"],
                         cfg["optimizer"], self.traffic["checked_steps"], mm)

    # -- faults (perfbench.faults) -----------------------------------------
    def faults(self):
        return ("frozen", "half_batch", "altered", "codebook_grad")

    def plant(self, fault: str) -> None:
        """``half_batch``: the training nodes of each step cut to their
        first half.  ``altered``: one bit of the first node's codes flipped
        in the runtime's code buffer, where Algorithm 1's answer is kept."""
        rt = self.rt
        if fault == "half_batch":
            batch = rt.source._batch
            keep = batch["ids"].shape[0] // 2
            batch["ids"], batch["labels"] = batch["ids"][:keep], batch["labels"][:keep]
        else:
            rt.params["embed"]["codes_buf"][0, 0] ^= 1

    def control(self) -> dict:
        """The control's readings: the reference in TF32, in the program's
        place."""
        return self.reference(ref.tf32_mm)

    def compare(self, want: dict, got: Optional[dict] = None) -> Dict[str, float]:
        """The cell's numbers: the program's readings (or ``got``, a
        control's, whose codes are the reference's own) against the
        reference's ``want``."""
        if got is not None:
            return dict(compare_train(got, want), codes_gap=0.0)
        return dict(compare_train(self.observed, want),
                    codes_gap=codes_gap(self.program_codes, self.ref_codes))

"""Config dataclasses of the paper's GNN stack (counterpart of the GNN part
of ``repro/configs/base.py``).  Field names, defaults and order match the
JAX package, so a JAX ``RuntimeSpec.to_json()`` loads here unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.embedding import EmbeddingConfig


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    kind: str = "hash_full"   # dense | hash_full | hash_light | random_full | random_light
    c: int = 256
    m: int = 16
    d_c: int = 512
    d_m: int = 512
    n_layers: int = 3         # paper §5.3: l=3, d_c=d_m=512
    lookup_impl: str = "onehot"  # decode backend name or "auto" (core.backend)
    threshold: str = "median" # Algorithm-1 binarisation ("zero" = Charikar baseline)
    hops: int = 1             # §6.1 higher-order adjacency (A^k auxiliary)
    cache_capacity: int = 0   # hot-node decode cache slots (0 = disabled)
    cache_staleness: int = 0  # codebook versions a cached embedding may lag
    cache_plan_misses: bool = False
    param_dtype: Optional[str] = None   # e.g. "bfloat16"
    quantize: str = "none"              # "none" | "int8"
    tt_rank: int = 8
    codes_placement: str = "device"     # "device" | "host"

    def to_config(self, n_entities: int, d_e: int, compute_dtype: str) -> EmbeddingConfig:
        return EmbeddingConfig(
            kind=self.kind, n_entities=n_entities, d_e=d_e,
            c=self.c, m=self.m, d_c=self.d_c, d_m=self.d_m,
            n_layers=self.n_layers, lookup_impl=self.lookup_impl,
            compute_dtype=compute_dtype,
            threshold=self.threshold, hops=self.hops,
            cache_capacity=self.cache_capacity,
            cache_staleness=self.cache_staleness,
            param_dtype=self.param_dtype, quantize=self.quantize,
            tt_rank=self.tt_rank, codes_placement=self.codes_placement)


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    model: str                 # sage | gcn | sgc | gin
    n_nodes: int
    n_classes: int
    d_e: int = 64              # paper §C.1: d_e = 64
    hidden: int = 128
    n_gnn_layers: int = 2
    fanouts: Tuple[int, ...] = (15, 15)   # sage neighbour fanout
    task: str = "node"         # node | link
    embedding: EmbeddingSpec = dataclasses.field(default_factory=EmbeddingSpec)
    compute_dtype: str = "float32"

    def embedding_config(self) -> EmbeddingConfig:
        return self.embedding.to_config(self.n_nodes, self.d_e, self.compute_dtype)

"""Config dataclasses and the architecture registry (counterpart of
``repro/configs/base.py``).  Field names, defaults and order match the JAX
package, so a JAX ``RuntimeSpec.to_json()`` loads here unchanged and an
``LMConfig`` carries the same fields.

``get_config`` knows every architecture of the JAX package; the ones whose
family the port does not run yet (audio, vlm) raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.embedding import EmbeddingConfig

LM_SLICE = "the LM side-path slice (ROADMAP A.18)"


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


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    vocab_size: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    d_head: int = 0           # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    moe_impl: str = "ep"
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    # --- hybrid (zamba2-style shared attention) ---
    attn_every: int = 0
    # --- positional / attention details ---
    rope_variant: str = "standard"   # standard | half | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()
    qkv_bias: bool = False
    attn_impl: str = "xla"           # xla | flash (the Hopper kernel)
    # --- misc ---
    act: str = "swiglu"
    norm: str = "rmsnorm"
    input_mode: str = "tokens"       # tokens | audio_tokens | tokens_mrope
    n_codebooks: int = 1
    embedding: EmbeddingSpec = dataclasses.field(default_factory=EmbeddingSpec)
    compute_dtype: str = "bfloat16"
    vocab_round: int = 256           # pad vocab for TP divisibility
    loss_vocab_chunk: int = 0        # >0: chunked CE over vocab chunks
    remat: bool = True               # per-layer activation checkpointing
    unroll_scan: bool = False        # JAX dry-run knob; no effect here
    subquadratic: bool = False
    notes: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(self.n_heads, 1))

    @property
    def vocab_padded(self) -> int:
        r = self.vocab_round
        return -(-self.vocab_size // r) * r

    @property
    def n_experts_padded(self) -> int:
        """The experts padded to a multiple of 16 (the JAX package's
        production model axis), so both packages' params have one shape."""
        if not self.n_experts:
            return 0
        return -(-self.n_experts // 16) * 16 if self.n_experts % 16 else self.n_experts

    def embedding_config(self) -> EmbeddingConfig:
        return self.embedding.to_config(self.vocab_padded, self.d_model, self.compute_dtype)

    def param_count(self) -> int:
        """Analytic total parameter count, the JAX package's formula (the
        embedding counted as its dense-equivalent V x D table)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_padded
        Dh, H, K = self.head_dim, self.n_heads, self.n_kv_heads
        attn = D * H * Dh + 2 * D * K * Dh + H * Dh * D
        ffn = 3 * D * F if self.act == "swiglu" else 2 * D * F
        if self.family == "moe":
            ffn = self.n_experts * ffn + D * self.n_experts
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            DI = self.ssm_expand * D
            N = self.ssm_state
            Hs = DI // self.ssm_headdim
            ssm = D * (2 * DI + 2 * N + Hs) + DI * D + 4 * (DI + 2 * N)
        per_layer = {
            "dense": attn + ffn, "moe": attn + ffn, "audio": attn + ffn,
            "vlm": attn + ffn, "ssm": ssm, "hybrid": ssm,
        }[self.family]
        total = self.n_layers * per_layer
        if self.family == "hybrid" and self.attn_every:
            total += attn + 3 * D * F
        emb = V * D
        head = D * V * (self.n_codebooks if self.input_mode == "audio_tokens" else 1)
        return total + emb + head

    def active_param_count(self) -> int:
        """Parameters a token runs through (moe: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        D, F = self.d_model, self.d_ff
        ffn_all = self.n_experts * 3 * D * F
        ffn_act = self.moe_top_k * 3 * D * F
        return self.param_count() - self.n_layers * (ffn_all - ffn_act)


# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], LMConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str, **overrides) -> LMConfig:
    """The registered config, with ``overrides`` replaced field by field
    (``get_config("qwen1.5-0.5b", attn_impl="flash")``)."""
    from repro_torch.configs import archs
    if name in archs.NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} ({archs.NOT_PORTED[name]} family) is not ported "
            f"yet; it comes with {LM_SLICE}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    cfg = _REGISTRY[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def list_archs():
    """The architectures the port runs (``archs.NOT_PORTED`` has the rest)."""
    from repro_torch.configs import archs  # noqa: F401  (populates the registry)
    return sorted(_REGISTRY)

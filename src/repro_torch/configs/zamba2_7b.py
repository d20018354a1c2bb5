"""zamba2-7b [hybrid] — a Mamba2 backbone and ONE shared transformer block
called after every 6 mamba layers (one set of weights, a KV cache per call
site).  81L d_model=3584 32H (kv=32) d_head=112 d_ff=14336 vocab=32000
ssm_state=64 (counterpart of ``repro/configs/zamba2_7b.py``;
arXiv:2411.15242).
"""

from repro_torch.configs.base import EmbeddingSpec, LMConfig, register


@register("zamba2-7b")
def config() -> LMConfig:
    return LMConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        vocab_size=32000,
        n_heads=32,
        n_kv_heads=32,
        d_head=112,
        d_ff=14336,
        ssm_state=64,
        ssm_headdim=64,
        ssm_expand=2,
        attn_every=6,
        rope_variant="standard",
        act="swiglu",
        norm="rmsnorm",
        embedding=EmbeddingSpec(kind="hash_full"),
        subquadratic=True,
        notes="81 = 13 groups x 6 mamba layers + 3 tail; shared attn after each group",
    )

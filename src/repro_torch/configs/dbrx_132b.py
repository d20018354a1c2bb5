"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, 16 experts top-4 (counterpart of
``repro/configs/dbrx_132b.py``; published config: databricks/dbrx-base).

At 132 B parameters it needs tensor and expert parallelism to train; on
one device only its reduced config runs.
"""

from repro_torch.configs.base import EmbeddingSpec, LMConfig, register


@register("dbrx-132b")
def config() -> LMConfig:
    return LMConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        vocab_size=100352,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        n_experts=16,
        moe_top_k=4,
        rope_variant="standard",
        act="swiglu",
        norm="rmsnorm",
        embedding=EmbeddingSpec(kind="hash_full"),
    )

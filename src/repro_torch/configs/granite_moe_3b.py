"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
per expert, vocab=49155, 40 experts top-8 (fine-grained)
(counterpart of ``repro/configs/granite_moe_3b.py``; published config:
ibm-granite/granite-3.0-1b-a400m-base's family).

The 40 experts are padded to 48 (``LMConfig.n_experts_padded``, a
multiple of 16), the 8 pad experts' router logits masked to -1e30, so the
JAX package's params carry across with their shapes.
"""

from repro_torch.configs.base import EmbeddingSpec, LMConfig, register


@register("granite-moe-3b-a800m")
def config() -> LMConfig:
    return LMConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        vocab_size=49155,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        n_experts=40,
        moe_top_k=8,
        rope_variant="standard",
        act="swiglu",
        norm="rmsnorm",
        embedding=EmbeddingSpec(kind="hash_full"),
    )

"""yi-9b [dense] — llama-arch GQA. 48L d_model=4096 32H (GQA kv=4)
d_ff=11008 vocab=64000 (counterpart of ``repro/configs/yi_9b.py``;
published config: 01-ai/Yi-9B, arXiv:2403.04652)."""

from repro_torch.configs.base import EmbeddingSpec, LMConfig, register


@register("yi-9b")
def config() -> LMConfig:
    return LMConfig(
        name="yi-9b",
        family="dense",
        n_layers=48,
        d_model=4096,
        vocab_size=64000,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        rope_variant="standard",
        act="swiglu",
        norm="rmsnorm",
        embedding=EmbeddingSpec(kind="hash_full"),
    )

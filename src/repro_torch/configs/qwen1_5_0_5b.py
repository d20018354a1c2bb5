"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H (GQA kv=16) d_ff=2816
vocab=151936, QKV bias (counterpart of ``repro/configs/qwen1_5_0_5b.py``;
published config: Qwen/Qwen1.5-0.5B).

The 151,936 x 1024 embedding table is the pool's best case for the paper's
compression: ``hash_full`` replaces it with 16 B of codes per token plus a
shared decoder.
"""

from repro_torch.configs.base import EmbeddingSpec, LMConfig, register


@register("qwen1.5-0.5b")
def config() -> LMConfig:
    return LMConfig(
        name="qwen1.5-0.5b",
        family="dense",
        n_layers=24,
        d_model=1024,
        vocab_size=151936,
        n_heads=16,
        n_kv_heads=16,
        d_ff=2816,
        qkv_bias=True,
        rope_variant="standard",
        act="swiglu",
        norm="rmsnorm",
        embedding=EmbeddingSpec(kind="hash_full"),
    )

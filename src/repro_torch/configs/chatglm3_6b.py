"""chatglm3-6b [dense] — 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024; RoPE applied to half the head dims ("2d" RoPE), QKV bias
(counterpart of ``repro/configs/chatglm3_6b.py``; published config:
THUDM/chatglm3-6b, arXiv:2406.12793).
"""

from repro_torch.configs.base import EmbeddingSpec, LMConfig, register


@register("chatglm3-6b")
def config() -> LMConfig:
    return LMConfig(
        name="chatglm3-6b",
        family="dense",
        n_layers=28,
        d_model=4096,
        vocab_size=65024,
        n_heads=32,
        n_kv_heads=2,
        d_ff=13696,
        qkv_bias=True,
        rope_variant="half",
        act="swiglu",
        norm="rmsnorm",
        embedding=EmbeddingSpec(kind="hash_full"),
    )

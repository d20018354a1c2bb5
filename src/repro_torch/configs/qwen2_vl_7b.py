"""qwen2-vl-7b [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, QKV bias, M-RoPE (counterpart of ``repro/configs/qwen2_vl_7b.py``;
arXiv:2409.12191).

The vision tower is out of scope: a multimodal sequence is token ids and a
(3, B, S) M-RoPE position tensor (temporal, height, width streams), through
which dynamic resolution shows.  head_dim 128 gives 64 rotary frequencies,
split (16, 24, 24) between the three streams.
"""

from repro_torch.configs.base import EmbeddingSpec, LMConfig, register


@register("qwen2-vl-7b")
def config() -> LMConfig:
    return LMConfig(
        name="qwen2-vl-7b",
        family="vlm",
        n_layers=28,
        d_model=3584,
        vocab_size=152064,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        qkv_bias=True,
        rope_variant="mrope",
        mrope_sections=(16, 24, 24),
        input_mode="tokens_mrope",
        act="swiglu",
        norm="rmsnorm",
        embedding=EmbeddingSpec(kind="hash_full"),
    )

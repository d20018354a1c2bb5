"""mamba2-2.7b [ssm] — attention-free SSD (state-space duality), 64L
d_model=2560 vocab=50280 ssm_state=128 (counterpart of
``repro/configs/mamba2_2_7b.py``; arXiv:2405.21060).

d_inner = 2 x 2560 = 5120, headdim 64: 80 SSD heads.  Decoding keeps an
O(1) state a layer (``SSMCache``), not a KV cache.
"""

from repro_torch.configs.base import EmbeddingSpec, LMConfig, register


@register("mamba2-2.7b")
def config() -> LMConfig:
    return LMConfig(
        name="mamba2-2.7b",
        family="ssm",
        n_layers=64,
        d_model=2560,
        vocab_size=50280,
        ssm_state=128,
        ssm_headdim=64,
        ssm_expand=2,
        rope_variant="none",
        norm="rmsnorm",
        embedding=EmbeddingSpec(kind="hash_full"),
        subquadratic=True,
    )

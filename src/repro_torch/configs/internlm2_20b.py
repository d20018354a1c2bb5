"""internlm2-20b [dense] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 (counterpart of ``repro/configs/internlm2_20b.py``; published
config: internlm/internlm2-20b, arXiv:2403.17297)."""

from repro_torch.configs.base import EmbeddingSpec, LMConfig, register


@register("internlm2-20b")
def config() -> LMConfig:
    return LMConfig(
        name="internlm2-20b",
        family="dense",
        n_layers=48,
        d_model=6144,
        vocab_size=92544,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        rope_variant="standard",
        act="swiglu",
        norm="rmsnorm",
        embedding=EmbeddingSpec(kind="hash_full"),
    )

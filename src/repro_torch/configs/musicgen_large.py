"""musicgen-large [audio] — a decoder over 4 parallel EnCodec token streams.
48L d_model=2048 32H (MHA) d_ff=8192 vocab=2048 per codebook, 4 codebooks
(counterpart of ``repro/configs/musicgen_large.py``; arXiv:2306.05284).

Inputs are the 4 token streams (B, S, 4); the 4 codebook embeddings are
summed and the head predicts 4 x 2048 logits a position.  Sinusoidal
positions (no RoPE), LayerNorm and GELU.  A vocabulary of 2,048 a codebook
is smaller than the compressed table at the paper's widths, so ``dense`` is
the default; the compressed kinds stay selectable for ablation.
"""

from repro_torch.configs.base import EmbeddingSpec, LMConfig, register


@register("musicgen-large")
def config() -> LMConfig:
    return LMConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        vocab_size=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        rope_variant="none",
        act="gelu",
        norm="layernorm",
        input_mode="audio_tokens",
        n_codebooks=4,
        embedding=EmbeddingSpec(kind="dense"),
        notes="hash embedding inapplicable in practice: n=2048/codebook gives ratio<1",
    )

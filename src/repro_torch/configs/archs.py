"""Imports every ported per-architecture config module so the registry
populates; ``NOT_PORTED`` names the JAX package's other architectures with
their family (``get_config`` raises for them)."""

import repro_torch.configs.qwen1_5_0_5b  # noqa: F401

NOT_PORTED = {
    "zamba2-7b": "hybrid",
    "internlm2-20b": "dense",
    "chatglm3-6b": "dense",
    "yi-9b": "dense",
    "musicgen-large": "audio",
    "mamba2-2.7b": "ssm",
    "dbrx-132b": "moe",
    "granite-moe-3b-a800m": "moe",
    "qwen2-vl-7b": "vlm",
}

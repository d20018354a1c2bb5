"""Imports every ported per-architecture config module so the registry
populates; ``NOT_PORTED`` names the JAX package's other architectures with
their family (``get_config`` raises for them)."""

import repro_torch.configs.chatglm3_6b  # noqa: F401
import repro_torch.configs.internlm2_20b  # noqa: F401
import repro_torch.configs.qwen1_5_0_5b  # noqa: F401
import repro_torch.configs.yi_9b  # noqa: F401

NOT_PORTED = {
    "zamba2-7b": "hybrid",
    "musicgen-large": "audio",
    "mamba2-2.7b": "ssm",
    "dbrx-132b": "moe",
    "granite-moe-3b-a800m": "moe",
    "qwen2-vl-7b": "vlm",
}

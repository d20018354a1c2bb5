"""Imports every ported per-architecture config module so the registry
populates; ``NOT_PORTED`` names the JAX package's other architectures with
their family (``get_config`` raises for them)."""

import repro_torch.configs.chatglm3_6b  # noqa: F401
import repro_torch.configs.dbrx_132b  # noqa: F401
import repro_torch.configs.granite_moe_3b  # noqa: F401
import repro_torch.configs.internlm2_20b  # noqa: F401
import repro_torch.configs.mamba2_2_7b  # noqa: F401
import repro_torch.configs.qwen1_5_0_5b  # noqa: F401
import repro_torch.configs.yi_9b  # noqa: F401
import repro_torch.configs.zamba2_7b  # noqa: F401

NOT_PORTED = {
    "musicgen-large": "audio",
    "qwen2-vl-7b": "vlm",
}

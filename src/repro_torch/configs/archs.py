"""Imports every per-architecture config module so the registry populates;
``NOT_PORTED`` would name a JAX architecture the port does not run (none
is left).  ``ASSIGNED`` lists the dry run's ten archs in the JAX package's
order."""

import repro_torch.configs.chatglm3_6b  # noqa: F401
import repro_torch.configs.dbrx_132b  # noqa: F401
import repro_torch.configs.granite_moe_3b  # noqa: F401
import repro_torch.configs.internlm2_20b  # noqa: F401
import repro_torch.configs.mamba2_2_7b  # noqa: F401
import repro_torch.configs.musicgen_large  # noqa: F401
import repro_torch.configs.qwen1_5_0_5b  # noqa: F401
import repro_torch.configs.qwen2_vl_7b  # noqa: F401
import repro_torch.configs.yi_9b  # noqa: F401
import repro_torch.configs.zamba2_7b  # noqa: F401

NOT_PORTED: dict = {}

ASSIGNED = [
    "zamba2-7b", "qwen1.5-0.5b", "internlm2-20b", "chatglm3-6b", "yi-9b",
    "musicgen-large", "mamba2-2.7b", "dbrx-132b", "granite-moe-3b-a800m",
    "qwen2-vl-7b",
]

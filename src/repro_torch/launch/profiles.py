"""Per-architecture training profiles (counterpart of
``repro/launch/profiles.py``, field for field).

The JAX package's distribution hill-climbs chose, per architecture, the
strategy, the microbatch count, the Adam moments' storage and config
overrides for the train_4k cell:

  * below 10 B parameters: the model axis spent on data parallelism
    (``dp_over_model``), FSDP over the data axes alone;
  * granite (fine-grained MoE): dense-dispatch MoE under pure DP;
  * internlm2-20b and dbrx-132b: TP (and EP) with 8 microbatches and bf16
    moments;
  * prefill and decode keep the default TP policy.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.parallel.policy import Strategy

_DP_ALL = Strategy(dp_over_model=True)

# train_4k settings; a field left out keeps the baseline default
OPTIMIZED_TRAIN: Dict[str, Dict[str, Any]] = {
    "qwen1.5-0.5b": dict(strategy=_DP_ALL, microbatches=1,
                         moments_dtype="float32",
                         overrides={"loss_vocab_chunk": 19008}),
    "chatglm3-6b": dict(strategy=_DP_ALL, microbatches=1,
                        moments_dtype="bfloat16",
                        overrides={"loss_vocab_chunk": 8128}),
    "yi-9b": dict(strategy=_DP_ALL, microbatches=1, moments_dtype="bfloat16",
                  overrides={"loss_vocab_chunk": 8000}),
    "internlm2-20b": dict(strategy=Strategy(), microbatches=8,
                          moments_dtype="bfloat16"),
    "musicgen-large": dict(strategy=_DP_ALL, microbatches=1,
                           moments_dtype="float32"),
    "mamba2-2.7b": dict(strategy=_DP_ALL, microbatches=1,
                        moments_dtype="bfloat16",
                        overrides={"loss_vocab_chunk": 6304}),
    "zamba2-7b": dict(strategy=_DP_ALL, microbatches=1,
                      moments_dtype="bfloat16",
                      overrides={"loss_vocab_chunk": 4000}),
    "qwen2-vl-7b": dict(strategy=_DP_ALL, microbatches=1,
                        moments_dtype="bfloat16",
                        overrides={"loss_vocab_chunk": 19008}),
    "granite-moe-3b-a800m": dict(strategy=_DP_ALL, microbatches=1,
                                 moments_dtype="bfloat16",
                                 overrides={"moe_impl": "dense"}),
    "dbrx-132b": dict(strategy=Strategy(), microbatches=8,
                      moments_dtype="bfloat16"),
}


def optimized_cell_settings(arch: str, shape_kind: str) -> Optional[Dict[str, Any]]:
    if shape_kind == "train":
        return OPTIMIZED_TRAIN.get(arch)
    return None

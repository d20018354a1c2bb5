"""The input-shape set and each cell's input specs (counterpart of
``repro/launch/shapes.py``):

  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> prefill_step
  decode_32k   seq 32,768  global_batch 128   -> serve_step (1 new token,
                                                 the cache holds seq)
  long_500k    seq 524,288 global_batch 1     -> serve_step; ssm / hybrid only

``input_specs(cfg, shape)`` gives the step's batch as int32 tensors on the
``meta`` device: shapes and dtypes, no storage.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import LMConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def cell_is_applicable(cfg: LMConfig, shape: ShapeSpec) -> bool:
    """long_500k needs sub-quadratic sequence mixing."""
    return not (shape.name == "long_500k" and not cfg.subquadratic)


def _token_shape(cfg: LMConfig, batch: int, seq: int):
    if cfg.input_mode == "audio_tokens":
        return (batch, seq, cfg.n_codebooks)
    return (batch, seq)


def input_specs(cfg: LMConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """The step's batch argument as meta tensors:

    train: {"tokens", "labels"[, "positions"]}
    prefill: {"tokens"[, "positions"]}
    decode: {"tokens" (B, 1[, nq])[, "positions"]}

    ``positions`` (3, B, S) only for M-RoPE (``tokens_mrope``)."""
    if shape.kind not in ("train", "prefill", "decode"):
        raise ValueError(shape.kind)
    B = shape.batch
    S = 1 if shape.kind == "decode" else shape.seq

    def spec(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")

    specs = {"tokens": spec(*_token_shape(cfg, B, S))}
    if shape.kind == "train":
        specs["labels"] = spec(*_token_shape(cfg, B, S))
    if cfg.input_mode == "tokens_mrope":
        specs["positions"] = spec(3, B, S)
    return specs

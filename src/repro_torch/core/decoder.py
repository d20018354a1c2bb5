"""Decoder model (paper §3.2, Figure 2); counterpart of
``repro/core/decoder.py`` for the ``paper`` compression family.

codes (B, m) ints in [0, c)
  -> retrieve one vector per codebook (m codebooks, each (c, d_c))
  -> sum the m vectors (a ``DecodeBackend``, ``core.backend``)
  -> light variant: elementwise-rescale by trainable W0 (codebooks frozen)
     full  variant: no W0 (codebooks trainable)
  -> l-layer MLP with ReLU between linear layers: d_c -> d_m -> ... -> d_e

Params are a nested dict of tensors in the JAX package's layout: MLP
weights ``w{i}`` are (in, out) and apply as ``x @ w``.  Non-trainable
buffers end in ``_buf`` (``codebooks_buf`` of the light variant).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from repro_torch.core.backend import (NOT_PORTED, DecodeBackend,
                                      MixedPrecisionPolicy, family_of,
                                      get_backend, torch_dtype)
from repro_torch.nn.module import dense_init
from repro_torch.stages import stage

Params = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    c: int = 256           # code cardinality
    m: int = 16            # code length
    d_c: int = 512         # codebook vector dim
    d_m: int = 512         # MLP hidden dim
    d_e: int = 64          # output embedding dim
    n_layers: int = 3      # number of linear layers (paper's l)
    variant: str = "full"  # "full" (trainable codebooks) | "light" (frozen + W0)
    lookup_impl: str = "onehot"  # backend name, may select a family
    compute_dtype: str = "bfloat16"
    param_dtype: Optional[str] = None
    quantize: str = "none"     # "none" | "int8"
    tt_rank: int = 8           # TT rank r ("tt" family only)

    @property
    def family(self) -> str:
        return family_of(self.lookup_impl)

    def check_family(self) -> None:
        if self.family != "paper":
            raise NotImplementedError(
                f"the {self.family!r} compression family is not ported yet; "
                f"it comes with {NOT_PORTED[self.family]}")

    def precision_policy(self) -> MixedPrecisionPolicy:
        return MixedPrecisionPolicy(
            param_dtype=self.param_dtype or self.compute_dtype,
            compute_dtype=self.compute_dtype, reduce_dtype="float32",
            quantize=self.quantize)


def mlp_dims(cfg: DecoderConfig):
    if cfg.n_layers == 1:
        return [(cfg.d_c, cfg.d_e)]
    return ([(cfg.d_c, cfg.d_m)] + [(cfg.d_m, cfg.d_m)] * (cfg.n_layers - 2)
            + [(cfg.d_m, cfg.d_e)])


def init_decoder(generator: torch.Generator, cfg: DecoderConfig) -> Params:
    cfg.check_family()
    if cfg.variant not in ("light", "full"):
        raise ValueError(f"unknown decoder variant {cfg.variant!r}")
    dev = generator.device
    cb = dense_init(generator, (cfg.m, cfg.c, cfg.d_c), scale=1.0 / math.sqrt(cfg.m))
    params: Params = {}
    if cfg.variant == "light":
        params["codebooks_buf"] = cb
        params["w0"] = torch.ones(cfg.d_c, device=dev)
    else:
        params["codebooks"] = cb
    mlp = {}
    for i, dims in enumerate(mlp_dims(cfg)):
        mlp[f"w{i}"] = dense_init(generator, dims)
        mlp[f"b{i}"] = torch.zeros(dims[1], device=dev)
    params["mlp"] = mlp
    return params


def decode_stage(params: Params, codes2d: torch.Tensor, cfg: DecoderConfig,
                 backend: Optional[DecodeBackend] = None) -> torch.Tensor:
    """The codebook sum (and W0 rescale): codes (B, m) -> (B, d_c) f32."""
    cfg.check_family()
    policy = cfg.precision_policy()
    pdtype = torch_dtype(policy.param_dtype)
    light = cfg.variant == "light"
    cb = params["codebooks_buf" if light else "codebooks"].to(pdtype)
    w0 = params["w0"].to(pdtype) if light else None
    be = backend if backend is not None else get_backend(
        cfg.lookup_impl, device=codes2d.device, policy=policy)
    with stage("decode"):
        return be.decode(codes2d, cb, w0)


def apply_decoder(params: Params, codes: torch.Tensor, cfg: DecoderConfig, *,
                  backend: Optional[DecodeBackend] = None) -> torch.Tensor:
    """codes (..., m) int32 -> embeddings (..., d_e).  ``backend``
    overrides the config's ``lookup_impl``."""
    lead = codes.shape[:-1]
    h = apply_mlp(params, decode_stage(params, codes.reshape(-1, cfg.m), cfg, backend), cfg)
    return h.reshape(*lead, cfg.d_e)


def apply_mlp(params: Params, h: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """The MLP tail: decoded (B, d_c) -> (B, d_e) in the compute dtype."""
    dtype = torch_dtype(cfg.compute_dtype)
    mlp = params["mlp"]
    with stage("mlp"):
        h = h.to(dtype)
        for i in range(cfg.n_layers):
            h = h @ mlp[f"w{i}"].to(dtype) + mlp[f"b{i}"].to(dtype)
            if i < cfg.n_layers - 1:
                h = torch.relu(h)
    return h

"""Decoder model (paper §3.2, Figure 2); counterpart of
``repro/core/decoder.py``.

codes (B, m) ints in [0, c)
  -> retrieve one vector per codebook (m codebooks, each (c, d_c))
  -> sum the m vectors (a ``DecodeBackend``, ``core.backend``)
  -> light variant: elementwise-rescale by trainable W0 (codebooks frozen)
     full  variant: no W0 (codebooks trainable)
  -> l-layer MLP with ReLU between linear layers: d_c -> d_m -> ... -> d_e

``lookup_impl`` also selects the compression family, the layout of the
decode stage's params (``core.backend.family_of``):

  paper    m dense codebooks ``codebooks`` (m, c, d_c), the scheme above.
  hashemb  shared ``pools`` (m, c, d_c) and per-position weights ``wpos``
           (m, d_c); ``wpos`` is folded into the pools in f32 before the
           decode (``sum_j (wpos[j]*P[j])[h_j] == sum_j wpos[j]*P[j][h_j]``),
           so the base backend sees a dense table.  light: frozen
           ``pools_buf``, trainable ``wpos``.
  tt       the core pair ``tt_g0`` (m, c1, d1, r) / ``tt_g1`` (m, c2, r,
           d2), ``c = c1*c2``, ``d_c = d1*d2``, r = ``tt_rank``.  light:
           frozen ``tt_g0_buf`` / ``tt_g1_buf`` and a trainable ``w0``.

Params are a nested dict of tensors in the JAX package's layout: MLP
weights ``w{i}`` are (in, out) and apply as ``x @ w``.  Non-trainable
buffers end in ``_buf``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.backend import (DecodeBackend, MixedPrecisionPolicy,
                                      family_of, get_backend, torch_dtype,
                                      tt_factor_pair)
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

    def tt_dims(self) -> Tuple[int, int, int, int]:
        """(c1, c2, d1, d2): the balanced code and feature splits of the
        ``tt`` family's core pair."""
        return (*tt_factor_pair(self.c), *tt_factor_pair(self.d_c))

    def precision_policy(self) -> MixedPrecisionPolicy:
        return MixedPrecisionPolicy(
            param_dtype=self.param_dtype or self.compute_dtype,
            compute_dtype=self.compute_dtype, reduce_dtype="float32",
            quantize=self.quantize)

    def _decode_stage_params(self) -> int:
        """Parameters of the decode stage's table (family-dependent)."""
        if self.family == "tt":
            c1, c2, d1, d2 = self.tt_dims()
            return self.m * self.tt_rank * (c1 * d1 + c2 * d2)
        return self.m * self.c * self.d_c    # paper codebooks / hashemb pools

    def trainable_params(self) -> int:
        """Closed-form trainable parameters (paper §3.2, extended to the
        other families; MLP biases not counted, as the paper does not)."""
        mlp = sum(a * b for a, b in mlp_dims(self))
        light = self.variant == "light"
        if self.family == "hashemb":
            wpos = self.m * self.d_c
            return wpos + mlp + (0 if light else self._decode_stage_params())
        return mlp + (self.d_c if light else self._decode_stage_params())

    def frozen_params(self) -> int:
        return self._decode_stage_params() if self.variant == "light" else 0


def mlp_dims(cfg: DecoderConfig):
    if cfg.n_layers == 1:
        return [(cfg.d_c, cfg.d_e)]
    return ([(cfg.d_c, cfg.d_m)] + [(cfg.d_m, cfg.d_m)] * (cfg.n_layers - 2)
            + [(cfg.d_m, cfg.d_e)])


def _init_decode_stage(generator: torch.Generator, cfg: DecoderConfig) -> Params:
    """The family's decode-stage leaves, with the JAX package's names; the
    light variant freezes the table (``_buf``) and trains only ``w0`` or
    ``wpos``."""
    if cfg.variant not in ("light", "full"):
        raise ValueError(f"unknown decoder variant {cfg.variant!r}")
    dev = generator.device
    light = cfg.variant == "light"
    buf = "_buf" if light else ""
    params: Params = {}
    if cfg.family == "tt":
        c1, c2, d1, d2 = cfg.tt_dims()
        r = cfg.tt_rank
        # a table entry sums r products of two factors: factor std s gives
        # it variance r*s^4, so s = (m*r)^(-1/4) matches the paper
        # codebooks' 1/sqrt(m)
        s = float((cfg.m * r) ** -0.25)
        params["tt_g0" + buf] = dense_init(generator, (cfg.m, c1, d1, r), scale=s)
        params["tt_g1" + buf] = dense_init(generator, (cfg.m, c2, r, d2), scale=s)
    else:
        name = "pools" if cfg.family == "hashemb" else "codebooks"
        params[name + buf] = dense_init(generator, (cfg.m, cfg.c, cfg.d_c),
                                        scale=1.0 / math.sqrt(cfg.m))
    if cfg.family == "hashemb":
        # wpos = 1 decodes the plain pool sum at init; trainable in both
        # variants (in the light one it is the per-position W0)
        params["wpos"] = torch.ones(cfg.m, cfg.d_c, device=dev)
    elif light:
        params["w0"] = torch.ones(cfg.d_c, device=dev)
    return params


def init_decoder(generator: torch.Generator, cfg: DecoderConfig) -> Params:
    params = _init_decode_stage(generator, cfg)
    dev = generator.device
    mlp = {}
    for i, dims in enumerate(mlp_dims(cfg)):
        mlp[f"w{i}"] = dense_init(generator, dims)
        mlp[f"b{i}"] = torch.zeros(dims[1], device=dev)
    params["mlp"] = mlp
    return params


def _decode_stage_operands(params: Params, cfg: DecoderConfig, pdtype: torch.dtype):
    """The backend's ``(codebooks, w0)`` from the params, in the storage
    dtype.  hashemb folds ``wpos`` into the pools in f32 (exact, and
    differentiable to both); tt passes its core pair as a tuple."""
    buf = "_buf" if cfg.variant == "light" else ""
    w0 = params["w0"].to(pdtype) if "w0" in params else None
    if cfg.family == "hashemb":
        pools = params["pools" + buf].float()
        return (pools * params["wpos"].float()[:, None, :]).to(pdtype), None
    if cfg.family == "tt":
        return (params["tt_g0" + buf].to(pdtype), params["tt_g1" + buf].to(pdtype)), w0
    return params["codebooks" + buf].to(pdtype), w0


def decode_stage(params: Params, codes2d: torch.Tensor, cfg: DecoderConfig,
                 backend: Optional[DecodeBackend] = None, *, frontier: bool = False,
                 plan=None) -> torch.Tensor:
    """The codebook sum (and W0 rescale): codes (B, m) -> (B, d_c) f32.
    ``frontier``: the rows are a frontier's (``DecodeBackend.decode_frontier``:
    under a mesh, this rank's block, and every rank's rows come back);
    ``plan`` its ``OwnerPlan``."""
    policy = cfg.precision_policy()
    cb, w0 = _decode_stage_operands(params, cfg, torch_dtype(policy.param_dtype))
    be = backend if backend is not None else get_backend(
        cfg.lookup_impl, device=codes2d.device, policy=policy)
    with stage("decode"):
        if frontier:
            return be.decode_frontier(codes2d, cb, w0, plan=plan)
        return be.decode(codes2d, cb, w0)


def apply_decoder(params: Params, codes: torch.Tensor, cfg: DecoderConfig, *,
                  backend: Optional[DecodeBackend] = None, frontier: bool = False,
                  plan=None) -> torch.Tensor:
    """codes (..., m) int32 -> embeddings (..., d_e).  ``backend``
    overrides the config's ``lookup_impl``.  ``frontier`` and ``plan``
    (a frontier's flat (U, m) codes and its ``graph.sampler.OwnerPlan``)
    go to ``decode_stage``; under a mesh the MLP then runs on every rank's
    rows."""
    if frontier:
        h = decode_stage(params, codes, cfg, backend, frontier=True, plan=plan)
        return apply_mlp(params, h, cfg)
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

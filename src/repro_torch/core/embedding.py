"""Drop-in embedding layer with optional hash compression (paper §4);
counterpart of ``repro/core/embedding.py``.

``EmbeddingConfig.kind`` selects:
  dense         — conventional trainable table (the paper's NC baseline)
  hash_full     — LSH codes + full decoder (trainable codebooks)
  hash_light    — LSH codes + light decoder (frozen codebooks + W0)
  random_full   — ALONE random codes + full decoder
  random_light  — ALONE random codes + light decoder

For compressed kinds the per-entity state is a packed code row
(``codes_buf``, int64 words holding the uint32 bit patterns); the decoder
parameters are shared by all entities.  ``lookup_impl`` may select another
compression family (``core.decoder``): ``hashemb`` stores no codes at all
(``needs_codes`` is False) and hashes each id at lookup
(``codes.position_codes``); ``tt`` keeps the codes and factorises the
codebooks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import codes as codes_lib
from repro_torch.core import lsh
from repro_torch.core.backend import DecodeBackend, family_of, torch_dtype
from repro_torch.core.decoder import (DecoderConfig, Params, apply_decoder,
                                      init_decoder)
from repro_torch.stages import stage

COMPRESSED_KINDS = ("hash_full", "hash_light", "random_full", "random_light")


@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
    kind: str                 # dense | hash_full | hash_light | random_full | random_light
    n_entities: int
    d_e: int
    c: int = 256
    m: int = 16
    d_c: int = 512
    d_m: int = 512
    n_layers: int = 3
    lookup_impl: str = "onehot"
    compute_dtype: str = "bfloat16"
    param_dtype: Optional[str] = None
    quantize: str = "none"
    threshold: str = "median"
    hops: int = 1
    cache_capacity: int = 0
    cache_staleness: int = 0
    tt_rank: int = 8
    codes_placement: str = "device"

    @property
    def is_compressed(self) -> bool:
        return self.kind in COMPRESSED_KINDS

    @property
    def family(self) -> str:
        """Compression family of ``lookup_impl``: "paper", "hashemb" or "tt"."""
        return family_of(self.lookup_impl)

    @property
    def needs_codes(self) -> bool:
        """Whether the config stores a per-entity ``codes_buf``: hashemb
        hashes the ids at lookup instead."""
        return self.is_compressed and self.family != "hashemb"

    def decoder_config(self) -> DecoderConfig:
        variant = "light" if self.kind.endswith("light") else "full"
        return DecoderConfig(
            c=self.c, m=self.m, d_c=self.d_c, d_m=self.d_m, d_e=self.d_e,
            n_layers=self.n_layers, variant=variant,
            lookup_impl=self.lookup_impl, compute_dtype=self.compute_dtype,
            param_dtype=self.param_dtype, quantize=self.quantize,
            tt_rank=self.tt_rank)


def make_codes(generator: torch.Generator, cfg: EmbeddingConfig, aux=None,
               projections=None) -> torch.Tensor:
    """Encoding stage: packed codes ``(n, n_words)`` int64.  ``aux`` is the
    auxiliary matrix A (dense or CSR) for hash kinds."""
    if cfg.kind.startswith("hash"):
        if aux is None:
            raise ValueError(
                "hash embedding kinds need auxiliary information (adjacency, "
                "co-occurrence or pre-trained embeddings); got aux=None")
        if aux.shape[0] != cfg.n_entities:
            raise ValueError(f"aux rows {aux.shape[0]} != n_entities {cfg.n_entities}")
        return lsh.encode_lsh(aux, cfg.c, cfg.m, generator=generator,
                              projections=projections,
                              threshold=cfg.threshold, hops=cfg.hops)
    return lsh.encode_random(generator, cfg.n_entities, cfg.c, cfg.m)


def init_embedding(generator: torch.Generator, cfg: EmbeddingConfig,
                   codes: Optional[torch.Tensor] = None, aux=None) -> Params:
    if cfg.codes_placement != "device":
        raise NotImplementedError(
            f"codes_placement={cfg.codes_placement!r} is not ported yet; it "
            f"comes with the codes-on-host slice (ROADMAP A.15)")
    dev = generator.device
    if cfg.kind == "dense":
        return {"table": torch.randn(cfg.n_entities, cfg.d_e, generator=generator,
                                     device=dev) * 0.02}
    if not cfg.is_compressed:
        raise ValueError(f"unknown embedding kind {cfg.kind!r}")
    if not cfg.needs_codes:
        return {"decoder": init_decoder(generator, cfg.decoder_config())}
    if codes is None:
        codes = make_codes(generator, cfg, aux)
    expected = (cfg.n_entities, codes_lib.n_words(cfg.c, cfg.m))
    if tuple(codes.shape) != expected:
        raise ValueError(f"codes shape {tuple(codes.shape)} != {expected}")
    return {"codes_buf": codes_lib.from_uint32(codes).to(dev),
            "decoder": init_decoder(generator, cfg.decoder_config())}


def lookup_codes(params: Params, ids: torch.Tensor, cfg: EmbeddingConfig
                 ) -> torch.Tensor:
    """ids (...,) -> codes (..., m) int32: the stored row unpacked, or
    (hashemb) the id's position hashes."""
    with stage("unpack"):
        if not cfg.needs_codes:
            return codes_lib.position_codes(ids.reshape(-1), cfg.c, cfg.m).reshape(
                *ids.shape, cfg.m)
        packed = params["codes_buf"][ids.to(torch.int64)]
        return codes_lib.unpack_codes(packed, cfg.c, cfg.m)


def embed_lookup(params: Params, ids: torch.Tensor, cfg: EmbeddingConfig, *,
                 backend: Optional[DecodeBackend] = None) -> torch.Tensor:
    """ids (...,) -> embeddings (..., d_e).  ``backend`` is an optional
    resolved ``DecodeBackend`` overriding ``cfg.lookup_impl``."""
    if cfg.kind == "dense":
        return params["table"].to(torch_dtype(cfg.compute_dtype))[ids.to(torch.int64)]
    return apply_decoder(params["decoder"], lookup_codes(params, ids, cfg),
                         cfg.decoder_config(), backend=backend)


def decode_all(params: Params, cfg: EmbeddingConfig, block: int = 8192,
               backend: Optional[DecodeBackend] = None) -> torch.Tensor:
    """The full reconstructed table, decoded in blocks to bound peak memory."""
    if cfg.kind == "dense":
        return params["table"]
    dev = params["decoder"]["mlp"]["w0"].device
    with torch.no_grad():
        return torch.cat([
            embed_lookup(params, torch.arange(s, min(s + block, cfg.n_entities),
                                              device=dev), cfg, backend=backend)
            for s in range(0, cfg.n_entities, block)])

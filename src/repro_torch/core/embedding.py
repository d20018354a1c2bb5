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

``codes_placement="host"`` keeps the packed buffer in host RAM: the params
carry only the decoder, and every lookup takes the batch's packed rows
(``codes=``, gathered on the host by ``graph.sampler.attach_codes``), which
replace the ``codes_buf[ids]`` gather bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import codes as codes_lib
from repro_torch.core import lsh
from repro_torch.core.backend import (DecodeBackend, family_of, frontier_rows, table_rows,
                                      torch_dtype)
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

    @property
    def codes_on_host(self) -> bool:
        """Whether the codes exist but stay in host RAM (no ``codes_buf``):
        lookups take the batch's packed rows."""
        return self.needs_codes and self.codes_placement == "host"

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
    """Params of the embedding.  A compressed kind draws its codes first
    unless ``codes`` is given, then the decoder; under
    ``codes_placement="host"`` the params carry only the decoder (the caller
    keeps the codes) and nothing is drawn for them."""
    if cfg.codes_placement not in ("device", "host"):
        raise ValueError(
            f"unknown codes_placement {cfg.codes_placement!r} "
            f"(expected 'device' or 'host')")
    dev = generator.device
    if cfg.kind == "dense":
        return {"table": torch.randn(cfg.n_entities, cfg.d_e, generator=generator,
                                     device=dev) * 0.02}
    if not cfg.is_compressed:
        raise ValueError(f"unknown embedding kind {cfg.kind!r}")
    if not cfg.needs_codes or cfg.codes_on_host:
        return {"decoder": init_decoder(generator, cfg.decoder_config())}
    if codes is None:
        codes = make_codes(generator, cfg, aux)
    expected = (cfg.n_entities, codes_lib.n_words(cfg.c, cfg.m))
    if tuple(codes.shape) != expected:
        raise ValueError(f"codes shape {tuple(codes.shape)} != {expected}")
    return {"codes_buf": codes_lib.from_uint32(codes).to(dev),
            "decoder": init_decoder(generator, cfg.decoder_config())}


def lookup_codes(params: Params, ids: torch.Tensor, cfg: EmbeddingConfig,
                 codes=None) -> torch.Tensor:
    """ids (...,) -> codes (..., m) int32: the stored row unpacked, or
    (hashemb) the id's position hashes.  ``codes`` is the batch's packed
    rows for ``ids`` (``ids.shape + (n_words,)``, int64 bit patterns or
    uint32), gathered on the host; required under ``codes_placement="host"``,
    where the params carry no ``codes_buf``."""
    with stage("unpack"):
        if not cfg.needs_codes:
            return codes_lib.position_codes(ids.reshape(-1), cfg.c, cfg.m).reshape(
                *ids.shape, cfg.m)
        if codes is not None:
            packed = (codes if isinstance(codes, torch.Tensor) and codes.dtype == torch.int64
                      else codes_lib.from_uint32(codes)).to(ids.device)
        elif "codes_buf" in params:
            packed = params["codes_buf"][ids.to(torch.int64)]
        else:
            raise ValueError(
                "embed_lookup: params carry no codes_buf and no batch codes "
                "were passed — with codes_placement='host' every lookup must "
                "receive the frontier's packed rows via codes=...")
        return codes_lib.unpack_codes(packed, cfg.c, cfg.m)


def embed_lookup(params: Params, ids: torch.Tensor, cfg: EmbeddingConfig, *,
                 backend: Optional[DecodeBackend] = None, codes=None,
                 frontier: bool = False, plan=None) -> torch.Tensor:
    """ids (...,) -> embeddings (..., d_e).  ``backend`` is an optional
    resolved ``DecodeBackend`` overriding ``cfg.lookup_impl``; ``codes`` the
    batch's packed rows (``lookup_codes``).  ``frontier``: ``ids`` are a
    frontier's flat ids (under a mesh, this rank's block of a placed
    frontier, and the result holds every rank's rows), ``plan`` its
    ``graph.sampler.OwnerPlan`` for the owner-computes decode."""
    if cfg.kind == "dense":
        table = params["table"].to(torch_dtype(cfg.compute_dtype))
        if frontier:
            return frontier_rows(table, ids.to(torch.int64))
        return table_rows(table, ids)
    return apply_decoder(params["decoder"], lookup_codes(params, ids, cfg, codes),
                         cfg.decoder_config(), backend=backend, frontier=frontier, plan=plan)


def decode_all(params: Params, cfg: EmbeddingConfig, block: int = 8192,
               backend: Optional[DecodeBackend] = None, host_codes=None) -> torch.Tensor:
    """The full reconstructed table, decoded in blocks to bound peak memory.
    ``host_codes`` is the whole packed buffer (uint32) under
    ``codes_placement="host"``: each block's rows move to the device as the
    block is decoded."""
    if cfg.kind == "dense":
        return params["table"]
    if cfg.codes_on_host and host_codes is None:
        raise ValueError("decode_all: codes_placement='host' needs "
                         "host_codes (the full packed buffer)")
    dev = params["decoder"]["mlp"]["w0"].device
    blocks = []
    with torch.no_grad():
        for s in range(0, cfg.n_entities, block):
            e = min(s + block, cfg.n_entities)
            rows = host_codes[s:e] if cfg.codes_on_host else None
            blocks.append(embed_lookup(params, torch.arange(s, e, device=dev), cfg,
                                       backend=backend, codes=rows))
    return torch.cat(blocks)

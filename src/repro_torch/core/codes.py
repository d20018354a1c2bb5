"""Compositional-code storage layout (paper §3.1 footnote 1, §3.2).

A code vector of length ``m`` with cardinality ``c`` (``c`` a power of two)
is stored as ``n_bit = m * log2(c)`` bits, each element written MSB-first:
``[2, 0, 3, 1]`` with ``c=4`` becomes the bit string ``10 00 11 01``.  Bits
are packed into 32-bit words, little-endian within a word: bit ``i`` of the
code row lives in word ``i // 32`` at bit position ``i % 32``.

Counterpart of ``repro/core/codes.py``.  torch's ``uint32`` supports few
ops, so a packed word is held as its bit pattern in an ``int64`` tensor
(values in ``[0, 2**32)``); ``to_uint32`` / ``from_uint32`` convert at the
numpy boundary.  Integer codes are ``int32``, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32
MASK32 = 0xFFFFFFFF


def bits_per_code(c: int) -> int:
    """log2(c); validates that c is a power of two >= 2."""
    if c < 2 or (c & (c - 1)) != 0:
        raise ValueError(f"code cardinality c must be a power of two >= 2, got {c}")
    return int(c).bit_length() - 1


def n_bits(c: int, m: int) -> int:
    """Total bits per entity: m * log2(c)."""
    if m < 1:
        raise ValueError(f"code length m must be >= 1, got {m}")
    return m * bits_per_code(c)


def n_words(c: int, m: int) -> int:
    """32-bit words per entity."""
    return -(-n_bits(c, m) // WORD_BITS)


def from_uint32(packed) -> torch.Tensor:
    """numpy/tensor uint32 words -> int64 tensor holding the bit patterns."""
    if isinstance(packed, torch.Tensor):
        return packed.to(torch.int64) & MASK32
    return torch.from_numpy(np.asarray(packed, np.uint32).astype(np.int64))


def to_uint32(packed: torch.Tensor) -> np.ndarray:
    """int64 bit-pattern tensor -> numpy uint32 (the JAX package's layout)."""
    return packed.detach().cpu().numpy().astype(np.uint32)


def _shifts(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(n, n_bit) bool -> (n, n_words) int64 words (little-endian)."""
    bits = torch.as_tensor(bits).to(torch.int64)
    n, nb = bits.shape
    nw = -(-nb // WORD_BITS)
    pad = nw * WORD_BITS - nb
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(n, nw, WORD_BITS)
    return (bits << _shifts(WORD_BITS, bits.device)).sum(dim=-1)


def unpack_bits(packed: torch.Tensor, nb: int) -> torch.Tensor:
    """(n, n_words) int64 words -> (n, nb) bool."""
    packed = torch.as_tensor(packed).to(torch.int64)
    n, nw = packed.shape
    bits = (packed[..., None] >> _shifts(WORD_BITS, packed.device)) & 1
    return bits.reshape(n, nw * WORD_BITS)[:, :nb].to(torch.bool)


def _msb_weights(b: int, device) -> torch.Tensor:
    return torch.ones((), dtype=torch.int32, device=device) << torch.arange(
        b - 1, -1, -1, dtype=torch.int32, device=device)


def bits_to_codes(bits: torch.Tensor, c: int, m: int) -> torch.Tensor:
    """(n, n_bit) bool -> (n, m) int32, each element in [0, c).  MSB-first."""
    b = bits_per_code(c)
    bits = torch.as_tensor(bits).to(torch.int32).reshape(bits.shape[0], m, b)
    return (bits * _msb_weights(b, bits.device)).sum(-1).to(torch.int32)


def codes_to_bits(codes: torch.Tensor, c: int, m: int) -> torch.Tensor:
    """(n, m) int -> (n, n_bit) bool.  MSB-first per element."""
    b = bits_per_code(c)
    codes = torch.as_tensor(codes).to(torch.int32)
    shifts = torch.arange(b - 1, -1, -1, dtype=torch.int32, device=codes.device)
    bits = (codes[..., None] >> shifts) & 1
    return bits.reshape(codes.shape[0], m * b).to(torch.bool)


def pack_codes(codes: torch.Tensor, c: int, m: int) -> torch.Tensor:
    """(n, m) int codes -> (n, n_words) int64 packed words."""
    return pack_bits(codes_to_bits(codes, c, m))


def unpack_codes(packed: torch.Tensor, c: int, m: int) -> torch.Tensor:
    """(..., n_words) int64 words -> (..., m) int32 codes.

    The decode-path prologue: pure shift/mask on the fetched rows."""
    b = bits_per_code(c)
    packed = torch.as_tensor(packed).to(torch.int64)
    lead = packed.shape[:-1]
    dev = packed.device
    bit_idx = (torch.arange(m, device=dev)[:, None] * b
               + torch.arange(b, device=dev)[None, :]).reshape(-1)
    words = packed[..., bit_idx // WORD_BITS]
    bits = (words >> (bit_idx % WORD_BITS)) & 1
    bits = bits.reshape(*lead, m, b).to(torch.int32)
    return (bits * _msb_weights(b, dev)).sum(-1).to(torch.int32)


def _mul32(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x * k mod 2**32`` for x in [0, 2**32) held in int64, without ever
    forming a product above 2**48 (int64 overflow is not relied on)."""
    lo, hi = k & 0xFFFF, k >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def position_codes(ids, c: int, m: int, seed: int = 0) -> torch.Tensor:
    """(B,) entity ids -> (B, m) int32 position-hash codes in [0, c).

    The ``hashemb`` family's hash functions (arXiv:2109.00101): position
    ``j`` mixes ``id`` with a per-position odd key through a splitmix32-style
    finaliser and keeps the top ``log2(c)`` bits.  Bitwise the JAX
    package's uint32 arithmetic, done in int64 with 32-bit masking."""
    b = bits_per_code(c)
    if m < 1:
        raise ValueError(f"code length m must be >= 1, got {m}")
    ids = torch.as_tensor(ids).to(torch.int64) & MASK32
    base = ((2 * seed + 1) * 0x85EBCA6B) & MASK32
    keys = (torch.arange(m, dtype=torch.int64, device=ids.device) * 0x9E3779B9
            + base) & MASK32
    x = ids[:, None] ^ keys[None, :]
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return (x >> (32 - b)).to(torch.int32)


def count_collisions(codes) -> int:
    """Number of entities sharing a code with an earlier entity
    (``n - n_unique``, the paper's Fig. 3 metric).  Host-side."""
    arr = codes.detach().cpu().numpy() if isinstance(codes, torch.Tensor) \
        else np.asarray(codes)
    return int(arr.shape[0] - np.unique(arr, axis=0).shape[0])


def code_capacity(c: int, m: int) -> int:
    """Number of distinct representable entities (2**n_bit)."""
    return 1 << n_bits(c, m)

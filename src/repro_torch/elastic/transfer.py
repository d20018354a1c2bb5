"""Checkpointless peer recovery: shard state over a chunked, checksummed
wire; counterpart of ``repro/elastic/transfer.py``.

When a shard dies mid-run, the survivors hold everything needed to go on:
data-parallel training replicates params and optimizer state on every
rank, and the batch source's state is a handful of integers, so recovery
never reads the checkpoint directory.

  ``pack_state``      state + JSON sidecar  ->  one npz-format byte payload
  ``chunk_payload``   payload  ->  fixed-size ``Chunk``s, each CRC-stamped
  ``transfer_state``  simulated send and receive with per-chunk
                      verification and bounded retransmission (faults
                      injected through ``FailurePlan.tamper``)
  ``unpack_state``    payload  ->  state on the template's devices and
                      dtypes (the checkpoint restore's leaf and shape checks)

The payload holds the checkpoint's leaves (``train.checkpoint._flatten``:
slash-joined paths, numpy copies, bf16 as its int16 bits) in an
``np.savez`` container, so the durable checkpoint and the peer transfer
capture the same thing.  ``np.savez`` stamps every zip entry with one fixed
date, so the same state packs to the same bytes on every rank and in every
run, and so do its chunks and CRCs.  ``transfer_state`` is the JAX
package's in-process loop over chunks; ``parallel.sharding.broadcast_bytes``
moves the same chunks and CRCs between ranks.
"""

from __future__ import annotations

import dataclasses
import io
import json
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.train.checkpoint import _flatten, _unflatten_into

# JSON sidecar leaf (the batch source's state) inside the npz payload; leaf
# paths are "/"-joined names, so they never take this one
EXTRA_KEY = "__extra__"


class ChunkCorruption(RuntimeError):
    """A chunk failed CRC verification on every allowed transmission."""


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One wire unit: ``payload`` plus the CRC32 computed *at the sender*.
    A tampered payload keeps the sender's CRC, so ``verify`` catches it."""

    seq: int
    total: int
    payload: bytes
    crc: int

    def verify(self) -> bool:
        return (zlib.crc32(self.payload) & 0xFFFFFFFF) == self.crc


@dataclasses.dataclass
class TransferStats:
    payload_bytes: int        # logical size of the transferred state
    bytes_transferred: int    # wire bytes including retransmissions
    chunks: int
    retransmits: int


def pack_state(state: Any, extra: Optional[Dict] = None) -> bytes:
    """A state (nested dicts of tensors and ints) and a JSON-able sidecar
    as one byte payload."""
    flat = _flatten(state)
    if EXTRA_KEY in flat:
        raise ValueError(f"state path collides with {EXTRA_KEY!r}")
    flat[EXTRA_KEY] = np.frombuffer(json.dumps(extra or {}).encode(), np.uint8)
    bio = io.BytesIO()
    np.savez(bio, **flat)
    return bio.getvalue()


def unpack_state(data: bytes, state_template: Any) -> Tuple[Any, Dict]:
    """Inverse of ``pack_state``: ``(state, extra)``, every leaf checked
    against the template and put on its device in its dtype; a missing leaf
    raises ``KeyError`` and a wrong shape ``ValueError``, as a checkpoint
    restore does."""
    with np.load(io.BytesIO(data)) as z:
        flat = {k: z[k] for k in z.files}
    extra = {}
    if EXTRA_KEY in flat:
        extra = json.loads(bytes(flat.pop(EXTRA_KEY)).decode())
    return _unflatten_into(state_template, flat), extra


def chunk_payload(data: bytes, chunk_bytes: int) -> List[Chunk]:
    """``data`` as CRC-stamped chunks of at most ``chunk_bytes`` (the last
    may be short; an empty payload is one empty chunk, so a receiver tells
    "empty" from "nothing arrived")."""
    if chunk_bytes < 1:
        raise ValueError(f"chunk_bytes must be >= 1, got {chunk_bytes}")
    views = [data[i:i + chunk_bytes] for i in range(0, len(data), chunk_bytes)] or [b""]
    return [Chunk(seq=i, total=len(views), payload=p, crc=zlib.crc32(p) & 0xFFFFFFFF)
            for i, p in enumerate(views)]


def corrupt(chunk: Chunk) -> Chunk:
    """Flip one payload byte, keeping the sender's CRC: the receiver's
    ``verify`` must catch it."""
    buf = bytearray(chunk.payload if chunk.payload else b"\x00")
    buf[len(buf) // 2] ^= 0xFF
    return dataclasses.replace(chunk, payload=bytes(buf))


def abort_message(chunk: Chunk, max_retries: int) -> str:
    return (f"chunk {chunk.seq}/{chunk.total} failed CRC on all {max_retries + 1} "
            f"transmissions — peer transfer aborted (state NOT installed); recover "
            f"from the checkpoint dir or raise ElasticSpec.max_transfer_retries")


def transfer_state(data: bytes, chunk_bytes: int = 1 << 20,
                   tamper: Optional[Callable[[int, int], bool]] = None,
                   max_retries: int = 2) -> Tuple[bytes, TransferStats]:
    """Move ``data`` over the simulated wire chunk by chunk: each chunk is
    sent again until its CRC verifies, at most ``max_retries`` times more,
    else ``ChunkCorruption``.  ``tamper(seq, attempt)`` corrupts that
    transmission (``FailurePlan.tamper``).  Returns the reassembled payload,
    ``data``'s bytes whenever it returns, and the wire's accounting."""
    chunks = chunk_payload(data, chunk_bytes)
    received: List[bytes] = []
    wire_bytes = retransmits = 0
    for chunk in chunks:
        for attempt in range(max_retries + 1):
            sent = corrupt(chunk) if tamper is not None and tamper(chunk.seq, attempt) else chunk
            wire_bytes += len(sent.payload)
            retransmits += attempt > 0
            if sent.verify():
                received.append(sent.payload)
                break
        else:
            raise ChunkCorruption(abort_message(chunk, max_retries))
    return b"".join(received), TransferStats(payload_bytes=len(data),
                                             bytes_transferred=wire_bytes,
                                             chunks=len(chunks), retransmits=retransmits)

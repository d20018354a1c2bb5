"""Elastic sharded training: checkpointless peer recovery from a dead
shard and exact rescale to another shard count; counterpart of
``repro/elastic``.

  ``ElasticSpec`` / ``ElasticManager`` / ``ElasticResult``: the step-fenced
      membership state machine (``manager``);
  ``FailurePlan``: deterministic fault injection (``failures``);
  ``pack_state`` / ``transfer_state`` / ``unpack_state``: the chunked,
      CRC-verified wire (``transfer``);
  ``rescale_spec`` / ``rescale_runtime``: exact shard-count changes
      (``rescale``; also ``GraphRuntime.rescale`` and
      ``GraphRuntime.rescale_checkpoint``).
"""

from repro_torch.elastic.failures import FailurePlan
from repro_torch.elastic.manager import (DEGRADED, HEALTHY, RESCALING, ElasticError,
                                         ElasticManager, ElasticResult, ElasticSpec,
                                         RecoveryReport)
from repro_torch.elastic.rescale import install_state, rescale_runtime, rescale_spec
from repro_torch.elastic.transfer import (Chunk, ChunkCorruption, TransferStats,
                                          chunk_payload, pack_state, transfer_state,
                                          unpack_state)

__all__ = [
    "HEALTHY", "DEGRADED", "RESCALING",
    "ElasticError", "ElasticManager", "ElasticResult", "ElasticSpec",
    "RecoveryReport", "FailurePlan",
    "Chunk", "ChunkCorruption", "TransferStats",
    "chunk_payload", "pack_state", "transfer_state", "unpack_state",
    "install_state", "rescale_runtime", "rescale_spec",
]

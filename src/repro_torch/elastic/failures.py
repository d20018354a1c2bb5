"""Deterministic fault injection for elastic training; counterpart of
``repro/elastic/failures.py``, pure Python, copied as it is.

A ``FailurePlan`` is a frozen, declarative schedule of faults — *when* a
shard dies, *when* its heartbeats lag, *which* transfer chunk arrives
corrupted — evaluated as pure predicates of ``(shard, step)`` /
``(seq, attempt)``.  Nothing here flips coins: the same plan against the
same run produces the same failure sequence every time, which is what lets
the tests assert bitwise post-recovery equality and the recovery numbers
reproduce.

The plan is consulted by ``ElasticManager`` (liveness at every step fence)
and by ``transfer.transfer_state`` (chunk tampering on the simulated wire).
Kill entries are *events*: the recovery they trigger consumes them
(manager-side), because the rescale renumbers survivors ``0..n-1`` and a
spent entry must not re-kill the new shard wearing the old id.  Entries
scheduled for later steps address the post-rescale topology by its new
ids, so multi-failure plans compose.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FailurePlan:
    """Declarative fault schedule.

    ``kill``: ``(shard, step)`` pairs — shard ``shard`` stops renewing its
    step lease from global step ``step`` onward (it is dead, permanently).

    ``heartbeat_delay``: ``(shard, from_step, n_steps)`` triples — shard
    ``shard`` misses its lease renewal for ``n_steps`` fences starting at
    ``from_step`` but is *not* dead; a delay shorter than
    ``ElasticSpec.lease_steps`` must be tolerated without triggering
    recovery (tested).

    ``corrupt_chunks``: chunk sequence numbers whose *first* transmission
    arrives with a flipped payload byte (the original checksum rides along,
    so the receiver detects the corruption and requests a retransmit).
    """

    kill: Tuple[Tuple[int, int], ...] = ()
    heartbeat_delay: Tuple[Tuple[int, int, int], ...] = ()
    corrupt_chunks: Tuple[int, ...] = ()

    def alive(self, shard: int, step: int) -> bool:
        """False once ``step`` reaches a scheduled kill for ``shard``."""
        return not any(s == shard and step >= at for s, at in self.kill)

    def delayed(self, shard: int, step: int) -> bool:
        """True while ``shard`` is inside a scheduled heartbeat-delay
        window at ``step`` (the lease is simply not renewed that fence)."""
        return any(s == shard and t0 <= step < t0 + n
                   for s, t0, n in self.heartbeat_delay)

    def tamper(self, seq: int, attempt: int) -> bool:
        """True when transmission ``attempt`` (0-based) of chunk ``seq``
        should arrive corrupted.  Only the first attempt is tampered —
        retransmits go through clean, so a plan exercises exactly one
        detect-and-retry cycle per listed chunk."""
        return attempt == 0 and seq in self.corrupt_chunks

"""ElasticManager: step-fenced shard membership for sharded training;
counterpart of ``repro/elastic/manager.py``.

State machine:

    HEALTHY --lease expired--> DEGRADED --survivors >= min_shards--> RESCALING
       ^                           |                                    |
       |                           +--survivors < min_shards--> ElasticError
       +------------- rescaled runtime resumes training ----------------+

Training advances through step fences (``GraphRuntime.train(fence=)``);
each fence renews the step lease of every shard the heartbeat source calls
alive (a deterministic ``FailurePlan`` here; a fleet wires real heartbeats,
with ``heartbeat_timeout_s`` as the wall-clock backstop).  A shard whose
lease lapses more than ``lease_steps`` fences is declared dead: the fence
raises ``FenceInterrupt``, training stops at a step boundary, and the
manager recovers without reading a checkpoint:

  1. pack the survivors' replicated state (params, optimizer, cache) and
     the batch source's consumed position (``transfer.pack_state``);
  2. push it through the chunked, CRC-verified wire
     (``transfer.transfer_state``: corrupted chunks are detected and sent
     again, at most ``max_transfer_retries`` times);
  3. build the runtime at the survivor count (``rescale.rescale_spec``,
     exact) and install the transferred copy; the new runtime's params are
     only the template.

The port runs one process a shard (``parallel.sharding``), and every rank
of the ``torch.distributed`` world runs the same manager program: each
computes the same fences from the plan, with no collective, so all stop at
the same step and recover together.  The survivors' group is built on every
world rank (``parallel.sharding.group_mesh``); each survivor packs, sends
through the wire and installs its own copy; a rank the plan killed takes
part in the group build, closes its runtime and trains no more, but goes on
replaying the fences so that it takes part in every later group build too,
and its result carries ``runtime=None`` and the losses it computed.  Later
kill entries address the survivors' new shard ids (``_consumed``).

The manager refuses runtimes with ``spec.ckpt_dir``: a checkpointed run's
``train`` resumes to an absolute step, which fights the manager's step
accounting; topology changes through checkpoints go through
``GraphRuntime.rescale_checkpoint``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import torch.distributed as dist

from repro_torch.elastic.failures import FailurePlan
from repro_torch.elastic.transfer import pack_state, transfer_state, unpack_state
from repro_torch.parallel.sharding import distributed, group_mesh, group_ranks
from repro_torch.train.loop import FenceInterrupt

HEALTHY = "HEALTHY"
DEGRADED = "DEGRADED"
RESCALING = "RESCALING"


class ElasticError(RuntimeError):
    """Recovery is impossible (e.g. survivors < ``min_shards``)."""


@dataclasses.dataclass(frozen=True)
class ElasticSpec:
    """Elastic-training knobs (``RuntimeSpec.elastic``).

    ``lease_steps``: fences a shard may miss before it is declared dead.
    ``min_shards``: floor on the survivor count; below it ``ElasticError``.
    ``chunk_bytes``: the wire's chunk size (one CRC a chunk, so also the
    retransmission unit).  ``max_transfer_retries``: retransmissions of a
    corrupted chunk before ``ChunkCorruption``.  ``heartbeat_timeout_s``:
    the wall-clock liveness backstop of a fleet; the step-driven plan only
    records it."""

    lease_steps: int = 2
    min_shards: int = 1
    chunk_bytes: int = 1 << 20
    max_transfer_retries: int = 2
    heartbeat_timeout_s: float = 30.0

    def __post_init__(self):
        if self.lease_steps < 1:
            raise ValueError(f"lease_steps must be >= 1, got {self.lease_steps}")
        if self.min_shards < 1:
            raise ValueError(f"min_shards must be >= 1, got {self.min_shards}")
        if self.chunk_bytes < 1:
            raise ValueError(f"chunk_bytes must be >= 1, got {self.chunk_bytes}")
        if self.max_transfer_retries < 0:
            raise ValueError(
                f"max_transfer_retries must be >= 0, got {self.max_transfer_retries}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ElasticSpec":
        return cls(**d)


@dataclasses.dataclass
class RecoveryReport:
    """One failure and its recovery: steps lost to detection and bytes
    moved over the wire."""

    failed_shards: Tuple[int, ...]
    detected_at_step: int      # global 0-based step index of the detecting fence
    steps_lost: int            # steps run past the dead shard's lease grace
    n_before: int
    n_after: int
    payload_bytes: int
    bytes_transferred: int     # wire bytes including retransmissions
    chunks: int
    retransmits: int


@dataclasses.dataclass
class ElasticResult:
    losses: List[float]
    steps: int                       # completed global steps (a departed rank: its own)
    reports: List[RecoveryReport]
    history: List[str]               # state-machine transitions, in order
    runtime: Any                     # the (possibly rescaled) live runtime; None once departed


class ElasticManager:
    """Owns shard membership for one training run over a ``GraphRuntime``.

    ``plan`` injects deterministic faults; ``None`` means no shard dies and
    ``run`` is plain training.  ``spec`` defaults to the runtime's
    ``RuntimeSpec.elastic`` (or ``ElasticSpec()``).  Under
    ``torch.distributed`` the runtime's group must be the whole world, and
    every rank runs the manager.  ``recovery_seconds`` holds each
    recovery's host-clock time, from the interrupt to the rescaled runtime
    ready for its first step."""

    def __init__(self, runtime, plan: Optional[FailurePlan] = None,
                 spec: Optional[ElasticSpec] = None):
        if runtime.spec.ckpt_dir:
            raise ValueError(
                "ElasticManager needs a checkpoint-free runtime: with "
                "spec.ckpt_dir set, train() uses absolute-step auto-resume "
                "semantics that fight the manager's step accounting.  Peer "
                "recovery never reads checkpoints anyway; for checkpoint-"
                "based topology changes use GraphRuntime.rescale_checkpoint.")
        self.rt = runtime
        self.plan = plan
        self.spec = spec or runtime.spec.elastic or ElasticSpec()
        self.state = HEALTHY
        self.history: List[str] = [HEALTHY]
        self.reports: List[RecoveryReport] = []
        self.recovery_seconds: List[float] = []
        self.n_shards = max(1, int(runtime.spec.n_shards))
        self._done = 0                      # completed global steps
        self._left_at: Optional[int] = None
        self._leases = {s: -1 for s in range(self.n_shards)}
        self._pending: Optional[Tuple[Tuple[int, ...], int]] = None
        # kill events already recovered from: after a rescale renumbers the
        # survivors 0..n-1, a spent (shard, step) entry must not fire again
        # against the new shard wearing the old id
        self._consumed: set = set()
        # the world ranks of the shards, in shard order
        self._members = list(range(self.n_shards))
        if distributed():
            mesh = getattr(runtime, "mesh", None)
            self._members = (group_ranks(mesh.group) if mesh is not None
                             else [dist.get_rank()])
            if len(self._members) != dist.get_world_size():
                raise ValueError(
                    f"ElasticManager runs on every rank of the world: the runtime's "
                    f"group has {len(self._members)} of {dist.get_world_size()} ranks")

    # -- liveness ---------------------------------------------------------
    def _fence(self, step: int) -> None:
        """Step-fence callback: renew leases, detect expiries.  ``step`` is
        the loop-local 0-based index just finished; the global index adds
        the steps completed before the current ``train`` call."""
        gstep = self._done + step
        for s in range(self.n_shards):
            if not self._alive(s, gstep):
                continue
            if self.plan is not None and self.plan.delayed(s, gstep):
                continue
            self._leases[s] = gstep
        dead = tuple(s for s in range(self.n_shards)
                     if gstep - self._leases[s] > self.spec.lease_steps)
        if dead:
            if self.rt is not None:
                self.state = DEGRADED
                self.history.append(DEGRADED)
            self._pending = (dead, gstep)
            raise FenceInterrupt(f"shards {list(dead)} lease-expired at step {gstep}")

    def _alive(self, shard: int, gstep: int) -> bool:
        """Plan liveness minus the kill events already recovered from."""
        if self.plan is None:
            return True
        return not any(s == shard and gstep >= at and (s, at) not in self._consumed
                       for s, at in self.plan.kill)

    # -- recovery ---------------------------------------------------------
    def _recover(self) -> None:
        t0 = time.perf_counter()
        dead, detected = self._pending
        self._pending = None
        self._consumed.update((s, at) for s, at in self.plan.kill if at <= detected)
        n_after = self.n_shards - len(dead)
        if n_after < self.spec.min_shards:
            raise ElasticError(
                f"shards {list(dead)} died at step {detected}; "
                f"{n_after} survivors < min_shards={self.spec.min_shards} "
                f"— cannot rescale, run must restart from a checkpoint")
        # detection latency in steps: how far past the dead shards' lease
        # grace the run went before the fence tripped
        steps_lost = detected - min(self._leases[s] for s in dead) - self.spec.lease_steps
        survivors = [self._members[s] for s in range(self.n_shards) if s not in dead]
        mesh = None
        if distributed():
            mesh = group_mesh(survivors, device=None if self.rt is None else self.rt.device)
        self._members, self.n_shards = survivors, n_after
        self._leases = {s: self._done - 1 for s in range(n_after)}
        if self.rt is None or (distributed() and mesh is None):
            if self.rt is not None:         # killed: leave the run
                self.rt.close()
                self.rt, self._left_at = None, self._done
            return
        # 1. this survivor's replicated state and the consumed position of
        #    its batch source
        source_state = (self.rt.data_iter.state_dict()
                        if hasattr(self.rt.data_iter, "state_dict") else None)
        payload = pack_state(self.rt.state, {"source": source_state})
        # 2. the wire: chunked, CRC-verified, bounded retransmission
        wire, stats = transfer_state(
            payload, chunk_bytes=self.spec.chunk_bytes,
            tamper=self.plan.tamper if self.plan is not None else None,
            max_retries=self.spec.max_transfer_retries)
        # 3. the survivors' runtime, trained from the transferred copy only
        self.state = RESCALING
        self.history.append(RESCALING)
        from repro_torch.elastic.rescale import install_state, rebuild, rescale_spec
        new_rt = rebuild(self.rt, rescale_spec(self.rt.spec, n_after),
                         group=None if mesh is None else mesh.group)
        state, extra = unpack_state(wire, new_rt.state)
        install_state(new_rt, state, extra.get("source"))
        self.rt.close()
        self.rt = new_rt
        self.state = HEALTHY
        self.history.append(HEALTHY)
        self.reports.append(RecoveryReport(
            failed_shards=dead, detected_at_step=detected, steps_lost=steps_lost,
            n_before=n_after + len(dead), n_after=n_after,
            payload_bytes=stats.payload_bytes, bytes_transferred=stats.bytes_transferred,
            chunks=stats.chunks, retransmits=stats.retransmits))
        self.recovery_seconds.append(time.perf_counter() - t0)

    def _replay(self, steps: int) -> Optional[int]:
        """A departed rank's stand-in for ``train``: the fences alone, so it
        stops where the survivors stop; the completed steps at an interrupt,
        else None."""
        for step in range(steps):
            try:
                self._fence(step)
            except FenceInterrupt:
                return step + 1
        return None

    # -- driver -----------------------------------------------------------
    def run(self, total_steps: int, on_metrics=None) -> ElasticResult:
        """Train for ``total_steps`` global steps, surviving every planned
        failure.  Returns the concatenated loss curve (the steps run while a
        shard was dead included: every rank computes them) and one
        ``RecoveryReport`` per recovery."""
        total = int(total_steps)
        losses: List[float] = []
        while self._done < total:
            if self.rt is None:
                interrupted = self._replay(total - self._done)
            else:
                res = self.rt.train(total - self._done, on_metrics=on_metrics,
                                    fence=self._fence)
                losses.extend(res.losses)
                interrupted = res.interrupted_at
            if interrupted is None:
                self._done = total
                break
            self._done += interrupted
            self._recover()
        return ElasticResult(losses=losses,
                             steps=self._done if self._left_at is None else self._left_at,
                             reports=self.reports, history=self.history, runtime=self.rt)

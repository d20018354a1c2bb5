"""Data-parallel ranks over ``torch.distributed``; counterpart of the GNN's
part of ``repro/parallel/sharding.py``.

The JAX package runs an N-shard GraphSAGE step as one program over a
1-axis ``("data",)`` mesh of N devices.  PyTorch has no single-process
mesh, so the port runs one process per shard, each running the same
program (as ``shard_map`` runs the same function on every device), joined
by a process group.  A ``DataMesh`` is that group as one rank sees it: its
rank, the rank count, its device and the collectives the decode backends
use.  ``use_sharding(mesh)`` makes it the active mesh for the code inside,
as the JAX package's context does; outside one, every collective backend
degrades to its base.

Collectives keep the ranks' bits equal: ``all_gather`` returns every rank's
block in rank order (callers sum partials in that order themselves, never
through an ``all_reduce`` whose order depends on the backend), and
``all_to_all`` exchanges blocks along dim 0.  Several ranks sharing one
card (NCCL refuses two ranks on one device) run over ``gloo``, which
takes CUDA tensors in both collectives itself.

``group_mesh`` builds the mesh of a subset of the world's ranks (the
survivors of an elastic recovery, the ranks of a rescaled run), and
``broadcast_bytes`` moves one payload from a rank to the rest of its group
in CRC-checked chunks (``elastic``'s state handed to ranks that join).

``spawn`` starts N ranks of a function in fresh processes (``spawn`` start
method, ``file://`` rendezvous: no TCP port to collide on) and returns their
results in rank order; ``init_from_env`` joins the group ``torchrun``
describes in the environment.  The LM's logical-axis rules are not here
(ROADMAP A.18).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import queue
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One rank's view of an N-rank data-parallel group.  ``group`` None is
    the default process group.  ``stats`` counts what this rank received
    from the others, by collective (bytes and calls)."""

    rank: int
    size: int
    device: torch.device
    group: Any = None
    stats: Dict[str, int] = dataclasses.field(default_factory=dict, compare=False)

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    def _count(self, name: str, nbytes: int) -> None:
        self.stats[name + "_bytes"] = self.stats.get(name + "_bytes", 0) + int(nbytes)
        self.stats[name + "_calls"] = self.stats.get(name + "_calls", 0) + 1

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` (equal shapes), in rank order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        self._count("all_gather", (self.size - 1) * x.numel() * x.element_size())
        return parts

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled all-to-all along dim 0: ``x``'s ``size`` equal blocks go
        to ranks 0..size-1, and the blocks received are concatenated in the
        senders' rank order."""
        if x.shape[0] % self.size:
            raise ValueError(f"all_to_all: {x.shape[0]} rows do not split over "
                             f"{self.size} ranks")
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        self._count("all_to_all", x.numel() * x.element_size() * (self.size - 1) // self.size)
        return out

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


class _State(threading.local):
    def __init__(self):
        self.mesh: Optional[DataMesh] = None


_STATE = _State()


@contextlib.contextmanager
def use_sharding(mesh: Optional[DataMesh]):
    """Make ``mesh`` the active mesh of this thread for the code inside."""
    prev = _STATE.mesh
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = prev


def current_mesh() -> Optional[DataMesh]:
    return _STATE.mesh


def data_axis(mesh: DataMesh) -> str:
    """The mesh axis carrying data-parallel rows (the port's meshes have
    only ``"data"``)."""
    return DATA_AXIS


def data_axis_size(mesh: Optional[DataMesh] = None) -> int:
    """Rank count of the given (or active) mesh; 1 without one."""
    mesh = mesh if mesh is not None else _STATE.mesh
    return 1 if mesh is None else mesh.size


def all_to_all(x: torch.Tensor, mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """``DataMesh.all_to_all`` on the given (or active) mesh: the
    owner-computes exchange (requests out, embeddings back)."""
    mesh = mesh if mesh is not None else _STATE.mesh
    if mesh is None:
        raise ValueError("all_to_all needs a mesh (use_sharding)")
    return mesh.all_to_all(x)


def rank_device(rank: int, device=None) -> torch.device:
    """A rank's device: ``device`` when given with an index or on the CPU,
    else ``cuda:(rank % device_count)``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the rank; pass device='cpu' to run "
                               "the ranks on the CPU")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def distributed() -> bool:
    """Whether this process is a rank of an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def data_mesh(n_shards: int, device=None, group=None) -> Optional[DataMesh]:
    """The mesh an N-shard run trains under: ``None`` for ``n_shards <= 1``
    (the single-device paths); this process's rank of the initialised
    process group, which must hold exactly ``n_shards`` ranks, else
    ``ValueError`` (a silent truncation would train another topology than
    the spec says)."""
    if n_shards <= 1:
        return None
    if not distributed():
        raise ValueError(
            f"n_shards={n_shards} but no torch.distributed process group is "
            f"initialised: start {n_shards} ranks (torchrun --nproc_per_node="
            f"{n_shards}, or repro_torch.parallel.sharding.spawn)")
    size = dist.get_world_size(group)
    if size != n_shards:
        raise ValueError(f"n_shards={n_shards} but the process group has {size} ranks")
    # the device follows the world rank, so a rank of a subgroup keeps its card
    return DataMesh(rank=dist.get_rank(group), size=size,
                    device=rank_device(dist.get_rank(), device), group=group)


def group_ranks(group=None) -> List[int]:
    """The world ranks of ``group`` (None: the default group), in group
    rank order."""
    if group is None:
        return list(range(dist.get_world_size()))
    return list(dist.get_process_group_ranks(group))


def group_mesh(ranks: Sequence[int], device=None) -> Optional[DataMesh]:
    """A ``DataMesh`` over the world ranks ``ranks``, group ranks in world
    rank order; ``None`` on a rank outside them.  Every world rank calls it,
    with the same ranks and in the same order as the others (the group is a
    ``dist.new_group`` with its default global synchronisation; all the
    world's ranks is the default group itself).  A rank keeps its device,
    ``rank_device(world rank, device)``."""
    ranks = sorted(int(r) for r in ranks)
    group = None if ranks == group_ranks() else dist.new_group(ranks)
    me = dist.get_rank()
    if me not in ranks:
        return None
    return DataMesh(rank=ranks.index(me), size=len(ranks), device=rank_device(me, device),
                    group=group)


def broadcast_bytes(data: Optional[bytes], mesh: DataMesh, src: int = 0,
                    chunk_bytes: int = 1 << 20,
                    tamper: Optional[Callable[[int, int], bool]] = None,
                    max_retries: int = 2):
    """One ``bytes`` payload from group rank ``src`` (which passes it; the
    others pass None) to every rank of ``mesh``, as uint8 tensors, in the
    chunks of ``elastic.transfer.chunk_payload``: each receiver checks a
    chunk against the sender's CRC, and a chunk that fails on any receiver
    is sent again, at most ``max_retries`` times more, else every rank
    raises ``ChunkCorruption``.  ``tamper(seq, attempt)`` corrupts that
    transmission at the receivers (``FailurePlan.tamper``).  Returns the
    payload and the ``TransferStats``, the same on every rank (wire bytes
    count each transmission once, as ``transfer_state``'s); the sender's
    ``chunk_bytes`` holds."""
    import numpy as np
    from repro_torch.elastic.transfer import (Chunk, ChunkCorruption, TransferStats,
                                              abort_message, chunk_payload, corrupt)
    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    src_world = group_ranks(mesh.group)[src]
    sender = mesh.rank == src

    def bcast(t: torch.Tensor) -> torch.Tensor:
        dist.broadcast(t, src=src_world, group=mesh.group)
        return t

    chunks = chunk_payload(data, chunk_bytes) if sender else None
    head = bcast(torch.tensor([len(data), len(chunks), chunk_bytes] if sender else [0, 0, 0],
                              dtype=torch.int64, device=dev)).tolist()
    size, total, chunk_bytes = (int(v) for v in head)
    crcs = bcast(torch.tensor([c.crc for c in chunks] if sender else [0] * total,
                              dtype=torch.int64, device=dev)).tolist()
    received, wire_bytes, retransmits = [], 0, 0
    for seq in range(total):
        n = min(chunk_bytes, size - seq * chunk_bytes)
        for attempt in range(max_retries + 1):
            if sender:
                buf = torch.from_numpy(np.frombuffer(chunks[seq].payload, np.uint8).copy()).to(dev)
            else:
                buf = torch.empty(n, dtype=torch.uint8, device=dev)
            if n:
                bcast(buf)
            got = Chunk(seq=seq, total=total, payload=buf.cpu().numpy().tobytes(),
                        crc=int(crcs[seq]))
            if not sender and tamper is not None and tamper(seq, attempt):
                got = corrupt(got)
            flags = [torch.empty(1, dtype=torch.int64, device=dev) for _ in range(mesh.size)]
            dist.all_gather(flags, torch.tensor([int(got.verify())], device=dev),
                            group=mesh.group)
            wire_bytes += n
            retransmits += attempt > 0
            if all(int(f) for f in flags):
                received.append(got.payload)
                break
        else:
            raise ChunkCorruption(abort_message(got, max_retries))
    return b"".join(received), TransferStats(payload_bytes=size, bytes_transferred=wire_bytes,
                                             chunks=total, retransmits=retransmits)


# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------

def _rank_main(rank: int, n: int, backend: str, init_file: str, timeout_s: float,
               fn: Callable, args: Sequence, results) -> None:
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method="file://" + init_file,
                                world_size=n, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
        results.put((rank, True, fn(rank, *args)))
    except BaseException:  # noqa: BLE001  (reported to the parent, which raises)
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, n: int, backend: str = "gloo", init_file: Optional[str] = None,
          args: Sequence = (), timeout_s: float = 900.0) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``n`` fresh processes joined by a process
    group of ``backend`` (``file://`` rendezvous on ``init_file``, a new
    temporary file by default) and return the results in rank order.
    ``fn`` and its arguments and results are pickled, so ``fn`` is a
    module-level function.  A rank that raises stops the others, and its
    traceback is raised here as ``RuntimeError``; so does a run past
    ``timeout_s``."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    own = init_file is None
    if own:
        fd, init_file = tempfile.mkstemp(prefix="repro_torch_rendezvous_")
        os.close(fd)
        os.unlink(init_file)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(r, n, backend, init_file, timeout_s, fn, tuple(args), results))
             for r in range(n)]
    for p in procs:
        p.start()
    out: List[Any] = [None] * n
    error = None
    deadline = time.monotonic() + timeout_s
    try:
        pending = set(range(n))
        while pending and error is None:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r in pending if not procs[r].is_alive()]
                if dead and results.empty():
                    error = f"rank(s) {dead} exited without a result"
                elif time.monotonic() > deadline:
                    error = f"ranks {sorted(pending)} still running after {timeout_s} s"
                continue
            pending.discard(rank)
            if ok:
                out[rank] = value
            else:
                error = f"rank {rank} failed:\n{value}"
    finally:
        for p in procs:
            if error is not None and p.is_alive():
                p.terminate()
            p.join(timeout=30.0)
            if p.is_alive():
                p.kill()
                p.join()
        if own and os.path.exists(init_file):
            os.unlink(init_file)
    if error is not None:
        raise RuntimeError(error)
    return out


def init_from_env(backend: Optional[str] = None) -> int:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``);
    ``backend`` defaults to NCCL where there is a card for every local
    rank, else gloo.  Returns the world size."""
    local = int(os.environ.get("LOCAL_RANK", 0))
    if backend is None:
        backend = ("nccl" if torch.cuda.is_available()
                   and torch.cuda.device_count() > local else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method="env://")
    return dist.get_world_size()

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
describes in the environment.

The LM's logical-axis layer (counterpart of the rest of the JAX module):
model code names a tensor's dims with *logical* axes (``logical(x,
"batch", "seq", "embed")``) and the active ``ShardingRules`` maps each
logical name to mesh axes.  ``_spec_for`` turns that into a spec: one entry
a dim, ``None``, an axis name or a tuple of names, as a JAX
``PartitionSpec`` holds them; an axis binds only where the product of its
sizes divides the dim (leading axes are shed until it does), and never
twice in one spec.  The mesh comes in two parts: a ``MeshSpec`` holds the
axis names and sizes (all the policy and the memory model need, at 256 or
512 "ranks"), and a ``Mesh`` is one rank's live view of it, with its
coordinates and one process group per line of every set of axes (ranks
are row-major over the axes, the last fastest, as ``jax.make_mesh`` lays
out devices).  Every rank builds the same groups in the same order, as
``torch.distributed`` requires.  ``DataMesh`` is the 1-axis ``Mesh`` of the
GNN's ranks over a group it is given: the same collectives and the same
``stats`` keys.  A ``VirtualMesh`` is one rank of a ``MeshSpec`` with no
process group at all (the dry run's): each collective returns new tensors
of its output's shape, counts its bytes in the same ``stats`` and records
the call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import os
import queue
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"


MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: Dict[str, MeshAxes]

    def resolve(self, name: Optional[str]) -> MeshAxes:
        if name is None:
            return None
        return self.rules.get(name)


# DP over (pod, data); TP/EP over model; SP (long-context cache) over data.
DEFAULT_RULES = ShardingRules(rules={
    "batch": ("pod", "data"),
    "batch_nopod": "data",
    "seq": None,
    "kv_seq": None,        # "data" for long-context decode (SP)
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "d_ff": "model",
    "experts": "model",
    "expert_ff": None,
    "vocab": "model",
    "ssm_heads": "model",
    "ssm_inner": "model",   # d_inner sharded on SSD-head boundaries
    "ssm_state": None,
    "fsdp": "data",        # parameter / optimizer-state sharding axis (ZeRO)
    "codebook": None,      # hash-decoder codebooks: replicated (small)
    "entities": None,      # packed code rows
    "frontier": "data",    # unique-node decode frontier: data-parallel rows
})


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Axis names and sizes of a mesh, nothing live: ``shape`` maps each
    name to its size in axis order, as a JAX mesh's ``shape`` does."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    def coords(self, rank: int) -> Dict[str, int]:
        """A rank's coordinate on each axis (row-major, the last axis fastest)."""
        out = {}
        for name, size in reversed(list(zip(self.axis_names, self.sizes))):
            out[name] = rank % size
            rank //= size
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coords: Dict[str, int]) -> int:
        rank = 0
        for name, size in zip(self.axis_names, self.sizes):
            rank = rank * size + coords[name]
        return rank

    def line(self, rank: int, axes: Sequence[str]) -> List[int]:
        """The ranks that share ``rank``'s coordinates off ``axes``, in rank
        order (row-major over ``axes`` in mesh order)."""
        axes = [a for a in self.axis_names if a in axes]
        base = self.coords(rank)
        out = []
        for combo in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(base)
            c.update(zip(axes, combo))
            out.append(self.rank_of(c))
        return out


def _axes_tuple(axes: MeshAxes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """One rank's view of a ``MeshSpec`` over the initialised process group:
    its coordinates, its device, and a process group for the line through
    it of every non-empty set of axes (``group``: the whole mesh's, None
    for the default group).  Every rank constructs it at the same point:
    ``dist.new_group`` runs for every line of every set, in one order, on
    every rank.  ``stats`` counts the bytes this rank receives, keyed
    ``"<axes>/<collective>"`` (``"data/all_gather"``), and the calls under
    ``..._calls``."""

    def __init__(self, spec: MeshSpec, device=None):
        if not distributed():
            if spec.size != 1:
                raise ValueError(f"a {spec.shape} mesh needs {spec.size} ranks of an "
                                 f"initialised process group; none is initialised")
            world, me = 1, 0
        else:
            world, me = dist.get_world_size(), dist.get_rank()
        if world != spec.size:
            raise ValueError(f"a {spec.shape} mesh needs {spec.size} ranks; the process "
                             f"group has {world}")
        self.spec = spec
        self.rank = me
        self.device = rank_device(me, device)
        self.stats: Dict[str, int] = {}
        self._groups: Dict[Tuple[str, ...], Any] = {}
        names = spec.axis_names
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                mine = None
                for line in self._lines(axes):
                    if len(line) == 1 or len(line) == world:
                        group = None          # trivial, or the default group
                    else:
                        group = dist.new_group(line)
                    if me in line:
                        mine = (group, line)
                self._groups[axes] = mine
        self.group = self._groups[names][0]

    def _lines(self, axes) -> List[List[int]]:
        seen, out = set(), []
        for r in range(self.spec.size):
            line = self.spec.line(r, axes)
            if line[0] not in seen:
                seen.add(line[0])
                out.append(line)
        return out

    def on(self, device) -> "Mesh":
        """The same mesh (rank, groups, ``stats``) with its tensors on
        ``device`` (gloo moves CPU and CUDA tensors alike)."""
        other = object.__new__(type(self))
        other.__dict__.update(self.__dict__)
        other.device = torch.device(device)
        return other

    @property
    def shape(self) -> Dict[str, int]:
        return self.spec.shape

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.spec.axis_names

    @property
    def size(self) -> int:
        return self.spec.size

    @property
    def coords(self) -> Dict[str, int]:
        return self.spec.coords(self.rank)

    def axes_size(self, axes: MeshAxes) -> int:
        n = 1
        for a in _axes_tuple(axes):
            n *= self.shape.get(a, 1)
        return n

    def index(self, axes: MeshAxes) -> int:
        """This rank's position on the line of ``axes`` (row-major)."""
        i, c = 0, self.coords
        for a in self.axis_names:
            if a in _axes_tuple(axes):
                i = i * self.shape[a] + c[a]
        return i

    def _line(self, axes: MeshAxes):
        key = tuple(a for a in self.axis_names if a in _axes_tuple(axes))
        return self._groups[key]

    def _count(self, axes: MeshAxes, name: str, nbytes: int) -> None:
        key = "+".join(a for a in self.axis_names if a in _axes_tuple(axes)) + "/" + name
        self.stats[key] = self.stats.get(key, 0) + int(nbytes)
        self.stats[key + "_calls"] = self.stats.get(key + "_calls", 0) + 1

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group)) if distributed() else "none"

    def all_gather(self, x: torch.Tensor, axes: MeshAxes,
                   name: str = "all_gather") -> List[torch.Tensor]:
        """Every rank's ``x`` on the line of ``axes`` (equal shapes), in line
        order; ``name`` is the operation it serves in ``stats``."""
        n = self.axes_size(axes)
        if n == 1:
            return [x]
        group, _ = self._line(axes)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        self._count(axes, name, (n - 1) * x.numel() * x.element_size())
        return parts

    def all_to_all(self, x: torch.Tensor, axes: MeshAxes,
                   name: str = "all_to_all") -> torch.Tensor:
        """Dim 0 of ``x`` in ``n`` equal blocks, block j to the line's rank
        j; the blocks received, in the senders' order."""
        n = self.axes_size(axes)
        if n == 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"all_to_all: {x.shape[0]} rows do not split over {n} ranks")
        group, _ = self._line(axes)
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        self._count(axes, name, x.numel() * x.element_size() * (n - 1) // n)
        return out

    def shift(self, x: torch.Tensor, axes: MeshAxes, by: int = 1) -> torch.Tensor:
        """``x`` moved ``by`` places along the line of ``axes``, cyclically:
        line rank i sends to i + by and receives from i - by (one
        ``all_to_all_single`` whose other blocks are empty)."""
        n = self.axes_size(axes)
        if n == 1 or by % n == 0:
            return x
        group, _ = self._line(axes)
        i = self.index(axes)
        x = x.contiguous()
        out = torch.empty_like(x)
        size = x.numel()
        send = [size if j == (i + by) % n else 0 for j in range(n)]
        recv = [size if j == (i - by) % n else 0 for j in range(n)]
        dist.all_to_all_single(out.reshape(-1), x.reshape(-1), output_split_sizes=recv,
                               input_split_sizes=send, group=group)
        self._count(axes, "shift", size * x.element_size())
        return out

    def barrier(self) -> None:
        if not distributed():
            return
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


class DataMesh(Mesh):
    """One rank's view of an N-rank data-parallel group: the 1-axis
    ``("data",)`` mesh over ``group`` (None: the default group), ``rank``
    this process's rank in it.  Its collectives run over the data axis
    unless told otherwise.  Built without a process group, it serves code
    that reads only the rank and the size."""

    def __init__(self, rank: int, size: int, device, group=None):
        self.spec = MeshSpec((DATA_AXIS,), (int(size),))
        self.rank = int(rank)
        self.device = torch.device(device)
        self.group = group
        self.stats: Dict[str, int] = {}
        self._groups = {(DATA_AXIS,): (group, list(range(int(size))))}

    def all_gather(self, x: torch.Tensor, axes: MeshAxes = DATA_AXIS,
                   name: str = "all_gather") -> List[torch.Tensor]:
        return super().all_gather(x, axes, name)

    def all_to_all(self, x: torch.Tensor, axes: MeshAxes = DATA_AXIS,
                   name: str = "all_to_all") -> torch.Tensor:
        return super().all_to_all(x, axes, name)


class VirtualMesh(Mesh):
    """The rank at ``rank`` of ``spec`` with no process group: the program
    runs as that rank would, on tensors without storage (the dry run traces
    under ``FakeTensorMode``).  Each collective returns new tensors of its
    output's shape (their values are never read), counts the bytes the
    rank would receive in ``stats``, as a live ``Mesh`` does, and appends
    (primitive, axes, result bytes, group size) to ``calls``."""

    def __init__(self, spec: MeshSpec, rank: int = 0, device="cpu"):
        self.spec = spec
        self.rank = int(rank)
        self.device = torch.device(device)
        self.stats: Dict[str, int] = {}
        self.calls: List[Tuple[str, str, int, int]] = []
        self.group = None
        self._groups = {}

    @property
    def backend(self) -> str:
        return "virtual"

    def _record(self, primitive: str, axes: MeshAxes, result_bytes: int, n: int) -> None:
        key = "+".join(a for a in self.axis_names if a in _axes_tuple(axes))
        self.calls.append((primitive, key, int(result_bytes), int(n)))

    def all_gather(self, x: torch.Tensor, axes: MeshAxes,
                   name: str = "all_gather") -> List[torch.Tensor]:
        n = self.axes_size(axes)
        if n == 1:
            return [x]
        parts = list(torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                                 device=x.device).unbind(0))
        nbytes = x.numel() * x.element_size()
        self._count(axes, name, (n - 1) * nbytes)
        self._record("all-gather", axes, n * nbytes, n)
        return parts

    def all_to_all(self, x: torch.Tensor, axes: MeshAxes,
                   name: str = "all_to_all") -> torch.Tensor:
        n = self.axes_size(axes)
        if n == 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"all_to_all: {x.shape[0]} rows do not split over {n} ranks")
        nbytes = x.numel() * x.element_size()
        self._count(axes, name, nbytes * (n - 1) // n)
        self._record("all-to-all", axes, nbytes, n)
        return torch.empty_like(x, memory_format=torch.contiguous_format)

    def shift(self, x: torch.Tensor, axes: MeshAxes, by: int = 1) -> torch.Tensor:
        n = self.axes_size(axes)
        if n == 1 or by % n == 0:
            return x
        nbytes = x.numel() * x.element_size()
        self._count(axes, "shift", nbytes)
        self._record("collective-permute", axes, nbytes, n)
        return torch.empty_like(x, memory_format=torch.contiguous_format)

    def barrier(self) -> None:
        return None


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device=None) -> Mesh:
    """The live mesh of ``shape`` over ``axes`` for this rank of the
    initialised process group, which must hold ``prod(shape)`` ranks."""
    return Mesh(MeshSpec(tuple(axes), tuple(int(s) for s in shape)), device=device)


class _State(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: ShardingRules = DEFAULT_RULES


_STATE = _State()


@contextlib.contextmanager
def use_sharding(mesh, rules: Optional[ShardingRules] = None):
    """Make ``mesh`` (a ``DataMesh``, a ``Mesh`` or a ``MeshSpec``) and
    ``rules`` the active ones of this thread for the code inside."""
    prev = (_STATE.mesh, _STATE.rules)
    _STATE.mesh = mesh
    _STATE.rules = rules or DEFAULT_RULES
    try:
        yield
    finally:
        _STATE.mesh, _STATE.rules = prev


def current_mesh():
    return _STATE.mesh


def current_rules() -> ShardingRules:
    return _STATE.rules


def _spec_for(shape: Sequence[int], names: Sequence[Optional[str]]) -> Optional[Spec]:
    """The spec of a tensor of ``shape`` whose dims are named ``names``
    under the active mesh and rules; None without a mesh."""
    mesh = _STATE.mesh
    if mesh is None:
        return None
    rules = _STATE.rules
    sizes = mesh.shape
    parts = []
    used: set = set()
    for dim, name in zip(shape, names):
        ax = tuple(a for a in _axes_tuple(rules.resolve(name))
                   if a in sizes and a not in used)
        # greedy fallback: drop leading axes until the product divides the dim
        while ax:
            size = 1
            for a in ax:
                size *= sizes[a]
            if size > 1 and dim % size == 0:
                break
            ax = ax[1:]
        if not ax:
            parts.append(None)
            continue
        used.update(ax)
        parts.append(ax[0] if len(ax) == 1 else ax)
    return tuple(parts)


def logical_sharding(shape: Sequence[int], *names: Optional[str]) -> Optional[Spec]:
    """The spec of a logical shape, or None when no mesh is active."""
    if len(names) != len(shape):
        raise ValueError(f"{len(names)} names for rank-{len(shape)} shape")
    return _spec_for(shape, names)


def shard_shape(shape: Sequence[int], spec: Optional[Spec], mesh) -> Tuple[int, ...]:
    """A rank's block of ``shape`` under ``spec``."""
    if spec is None:
        return tuple(shape)
    sizes = mesh.shape
    out = []
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        n = 1
        for a in _axes_tuple(axes):
            n *= sizes[a]
        out.append(dim // n)
    return tuple(out)


def logical(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """``x`` annotated with logical axis names: ``x`` itself.  Without a
    mesh, as in JAX.  Under one, ``x`` is already this rank's block (each
    rank holds what its spec says), so nothing moves here: the collectives
    sit where blocks change hands, in ``parallel.tensor``.  The names must
    match ``x``'s dims."""
    if len(names) != x.dim():
        raise ValueError(f"{len(names)} names for a rank-{x.dim()} tensor")
    return x


def data_axis(mesh) -> str:
    """The mesh axis carrying data-parallel rows: ``"data"`` when present,
    else the first axis."""
    return DATA_AXIS if DATA_AXIS in mesh.shape else mesh.axis_names[0]


def data_axis_size(mesh=None) -> int:
    """Rank count of the data axis of the given (or active) mesh; 1 without
    one."""
    mesh = mesh if mesh is not None else _STATE.mesh
    if mesh is None:
        return 1
    return mesh.shape[data_axis(mesh)]


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

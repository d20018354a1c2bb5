"""Checkpoints for fault tolerance (counterpart of ``repro/train/checkpoint.py``).

The JAX package's on-disk layout: ``step_XXXXXXXXXX/arrays.npz`` holds every
leaf of the state as a numpy array keyed by its slash-joined dict path, and
``manifest.json`` holds ``step``, ``extra`` (data-pipeline state, the
runtime spec), ``topology`` and the leaves' shapes and dtypes.

  * atomic: written to ``step_XXXXXXXXXX.tmp``, then ``os.replace``d; a
    stale ``.tmp`` left by a write cut short is swept when the directory
    is opened, and a step without a manifest is never listed;
  * tensors go to numpy on save (bf16 as its int16 bit pattern) and back to
    the template's device and dtype on restore; the integer steps of the
    train state and of the optimizer are leaves too, and so are the fields
    of a dataclass in the state (the hot-node ``CacheState``), keyed by
    position (``cache/0`` ... ``cache/7``, the JAX package's keys);
  * async: the device-to-host copy runs on the caller's thread, the write
    on a background thread, with at most one write outstanding;
  * retention: the newest ``keep`` checkpoints;
  * ``restore(expect_topology=...)`` raises ``TopologyMismatch`` before it
    touches an array when the checkpoint was written under another shard
    topology;
  * several ranks (``mesh=``, a ``parallel.sharding.DataMesh``): rank 0
    writes, since every rank holds the same state, and ``wait()`` returns
    on every rank only once rank 0's write is published, so every rank can
    restore it;
  * a state held as blocks (the LM across ranks, ``mesh=`` a live
    ``parallel.sharding.Mesh``): ``save_sharded`` gathers every leaf whole
    on every rank (``policy.gather_tree``) and rank 0 writes it, so the
    checkpoint is the one-rank layout; ``restore_sharded`` reads it on any
    mesh and keeps each leaf's block under that mesh's specs (a restart on
    another mesh).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def _fields(tree):
    """A dataclass's field values in order (a ``CacheState``): its leaves
    are keyed by position, as the JAX package keys a pytree's children."""
    return [getattr(tree, f.name) for f in dataclasses.fields(tree)]


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)) or dataclasses.is_dataclass(tree):
        for i, v in enumerate(_fields(tree) if dataclasses.is_dataclass(tree) else tree):
            yield from _leaves(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        # a copy even on the CPU: the step updates the state in place while
        # the write thread saves it
        return t.to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _leaves(tree)}


def _unflatten_into(tree, flat: Dict[str, np.ndarray], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_into(v, flat, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree):
        return type(tree)(*(_unflatten_into(v, flat, f"{prefix}{i}/")
                            for i, v in enumerate(_fields(tree))))
    if tree is None:
        return None
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key}")
    arr = flat[key]
    if isinstance(tree, torch.Tensor):
        if tuple(arr.shape) != tuple(tree.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs "
                             f"model {tuple(tree.shape)}")
        t = torch.from_numpy(np.array(arr))
        if tree.dtype == torch.bfloat16 and t.dtype == torch.int16:
            t = t.view(torch.bfloat16)
        return t.to(device=tree.device, dtype=tree.dtype)
    return type(tree)(arr.item())


def _jsonable(obj):
    """numpy values in ``extra`` (a cache shadow's arrays) as JSON lists and
    numbers."""
    if isinstance(obj, (np.ndarray, np.generic)):
        return obj.tolist()
    raise TypeError(f"{type(obj).__name__} is not JSON serializable")


class TopologyMismatch(ValueError):
    """A checkpoint written under one shard topology was asked to restore
    under another.  Raised at restore time, before any array is read."""


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, mesh=None):
        self.dir = directory
        self.keep = keep
        self.mesh = mesh
        self._writes = mesh is None or mesh.rank == 0
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)
        # a write cut short leaves a step_*.tmp behind: never listed, never
        # restored, and in the way of a later write of the same step
        for name in os.listdir(directory) if self._writes else ():
            if name.startswith("step_") and name.endswith(".tmp"):
                shutil.rmtree(os.path.join(directory, name), ignore_errors=True)

    # -- save -----------------------------------------------------------
    def save(self, step: int, state: Any, extra: Optional[Dict] = None,
             topology: Optional[Dict] = None) -> str:
        """``state``: nested dicts of tensors and ints; ``extra``: JSON-able
        (data-pipeline state, the runtime spec); ``topology``: JSON-able
        shard layout that ``restore(expect_topology=...)`` checks.  The
        write runs on a background thread: ``wait()`` before reading it.
        Under a mesh only rank 0 writes."""
        if not self._writes:
            return self._path(step)
        flat = _flatten(state)   # the device-to-host copy, on this thread
        self._join()             # at most one outstanding write
        self._thread = threading.Thread(
            target=self._write, args=(step, flat, extra or {}, topology),
            daemon=True)
        self._thread.start()
        return self._path(step)

    def save_sharded(self, step: int, state: Any, specs: Any,
                     extra: Optional[Dict] = None) -> str:
        """Every rank calls it: ``state``'s blocks (``specs``, a
        ``policy.state_shardings`` tree) gathered whole, then written by
        rank 0."""
        from repro_torch.parallel.policy import gather_tree
        whole = dict(state)
        whole["params"] = gather_tree(state["params"], specs["params"], self.mesh)
        whole["opt"] = dict(state["opt"])
        for m in ("mu", "nu"):
            whole["opt"][m] = gather_tree(state["opt"][m], specs["opt"][m], self.mesh)
        return self.save(step, whole, extra=extra)

    def restore_sharded(self, step: int, template: Any, specs: Any) -> Tuple[Any, Dict]:
        """(state, extra): ``template`` holds this rank's blocks under
        ``specs`` on this manager's mesh (any mesh: the checkpoint holds
        whole leaves); each leaf is read whole and its block kept."""
        from repro_torch.parallel.policy import block_slices
        path = self._path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        coords = self.mesh.coords
        flat = {}
        with np.load(os.path.join(path, "arrays.npz")) as z:
            for key in z.files:
                spec = specs
                for k in key.split("/"):
                    spec = spec.get(k) if isinstance(spec, dict) else None
                arr = z[key]
                if isinstance(spec, tuple) and any(spec):
                    arr = arr[block_slices(arr.shape, spec, self.mesh, coords)]
                flat[key] = arr
        return _unflatten_into(template, flat), manifest["extra"]

    def _join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def wait(self):
        """Until the last write is published (under a mesh, on every rank:
        every rank must call it)."""
        self._join()
        if self.mesh is not None:
            self.mesh.barrier()

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def _write(self, step: int, flat: Dict[str, np.ndarray], extra: Dict,
               topology: Optional[Dict] = None):
        final = self._path(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        manifest = {
            "step": step,
            "extra": extra,
            "topology": topology,
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in flat.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, default=_jsonable)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)   # atomic publish
        self._gc()

    def _gc(self):
        steps = self.list_steps()
        for s in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # -- load -----------------------------------------------------------
    def list_steps(self):
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, state_template: Any,
                expect_topology: Optional[Dict] = None) -> Tuple[Any, Dict]:
        """(state, extra): ``state_template`` gives the structure, shapes,
        devices and dtypes.  A manifest without a topology passes any
        ``expect_topology``."""
        path = self._path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        saved = manifest.get("topology")
        if expect_topology is not None and saved is not None and saved != expect_topology:
            raise TopologyMismatch(
                f"checkpoint at step {step} was written under topology {saved} "
                f"but the current run expects {expect_topology}.  Resuming across "
                f"shard topologies silently is never correct — use the exact-rescale "
                f"path (GraphRuntime.rescale / GraphRuntime.rescale_checkpoint) to "
                f"remap the owner partition and sampler state first.")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        return _unflatten_into(state_template, flat), manifest["extra"]

    def read_extra(self, step: Optional[int] = None) -> Optional[Dict]:
        """The ``extra`` manifest of a checkpoint (the latest by default),
        without reading its arrays; None if there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        with open(os.path.join(self._path(step), "manifest.json")) as f:
            return json.load(f)["extra"]

    def restore_latest(self, state_template: Any,
                       expect_topology: Optional[Dict] = None,
                       ) -> Optional[Tuple[int, Any, Dict]]:
        step = self.latest_step()
        if step is None:
            return None
        state, extra = self.restore(step, state_template,
                                    expect_topology=expect_topology)
        return step, state, extra

"""Optional per-stage clock for the serving and LM training paths.

Both paths mark their stages with ``with stage("name"):`` (marks may
nest: the LM's ``embed`` holds the decoder's ``unpack``, ``decode`` and
``mlp``).  While no
``StageTimer`` is active that is a shared no-op context: nothing is timed
and nothing synchronises.  Inside ``with StageTimer() as t:`` every marked
stage synchronises the card before and after it and appends its host-clock
milliseconds to ``t.ms[name]``, so the stages do not overlap and their sum
is the request's (or step's) time less what lies between the marks.  The
active timer is a module global and times only the thread that entered
it: marks reached in other threads (a prefetch producer) are no-ops.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import ContextManager, Dict, List, Optional

import torch

_NULL = contextlib.nullcontext()
_active: Optional["StageTimer"] = None


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Collects ``ms[stage] -> [milliseconds per pass]`` while active."""

    def __init__(self):
        self.ms: Dict[str, List[float]] = defaultdict(list)
        self._prev: Optional[StageTimer] = None
        self._thread: Optional[int] = None

    def __enter__(self) -> "StageTimer":
        global _active
        self._thread = threading.get_ident()
        self._prev, _active = _active, self
        return self

    def __exit__(self, *exc) -> None:
        global _active
        _active = self._prev

    @contextlib.contextmanager
    def span(self, name: str):
        _sync()
        t0 = time.perf_counter()
        yield
        _sync()
        self.ms[name].append((time.perf_counter() - t0) * 1e3)


def stage(name: str) -> ContextManager:
    """Time the enclosed work as ``name`` under the active ``StageTimer``."""
    timer = _active
    if timer is None or timer._thread != threading.get_ident():
        return _NULL
    return timer.span(name)

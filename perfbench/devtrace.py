"""Reading a ``torch.profiler`` Chrome trace: device activity, kernel
times by name, and the breakdown the result line carries."""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


class DeviceTrace:
    """The device's intervals and the host's operations of one trace, in
    seconds."""

    def __init__(self, events: List[dict]):
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
        self.device = sorted((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6, e["name"])
                             for e in dev)
        self.kernels = [(e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6, e["name"])
                        for e in dev if e["cat"] == "kernel"]
        self.host = sorted((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6, e["name"])
                           for e in host)
        self._host_starts = [h[0] for h in self.host]

    @classmethod
    def from_file(cls, path: Path) -> "DeviceTrace":
        return cls(json.loads(Path(path).read_text()).get("traceEvents", []))

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's activity, merged."""
        out: List[List[float]] = []
        for a, b, _ in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernel_time(self, pattern: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        hits = [b - a for a, b, name in self.kernels if rx.search(name)]
        return sum(hits), len(hits)

    def device_ops(self, top: int = 10) -> List[List]:
        """The device operations that took most time: [name, seconds]."""
        total: Dict[str, float] = defaultdict(float)
        for a, b, name in self.device:
            total[_short(name)] += b - a
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def _host_at(self, t: float) -> str:
        """The innermost host operation running at ``t``."""
        i = bisect.bisect_right(self._host_starts, t)
        for j in range(i - 1, max(i - 4000, -1), -1):
            a, b, name = self.host[j]
            if a <= t < b:
                return name
        return "(no host operation)"

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The device's idle time between its busy intervals, summed by the
        host operation that was running in the middle of each gap."""
        busy = self.busy_intervals()
        total: Dict[str, float] = defaultdict(float)
        for (_, end), (start, _) in zip(busy, busy[1:]):
            total[_short(self._host_at(0.5 * (end + start)))] += start - end
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def _short(name: str) -> str:
    return name if len(name) <= 160 else name[:157] + "..."

"""One run of one cell: set-up, the measured window, the traced window's
three parts, the correctness check, and the result line.

The window of ``--trace 0`` gives the end-to-end metrics.  ``--trace 1``
splits its window into three parts of equal length: a plain part (the
whole step's rate, for ``step_mfu``), a part under ``torch.profiler``
(device busy time, kernel times, the breakdown) and a part under the
program's ``StageTimer``, last because it synchronises the card at every
stage mark.  Both runs then check ``correct`` the same way, once the
window has closed, the peak memory has been read and the program's state
freed.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional

from perfbench import manifest

ROOT = manifest.ROOT
HERE = Path(__file__).resolve().parent
BUILD = ROOT / "build"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def process_start() -> float:
    """The ``time.time()`` at which this process started (from /proc), or
    now where /proc has no answer."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        boot = next(float(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                    if line.startswith("btime"))
        return boot + int(fields[19]) / ticks
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run must not load, each
    name compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def metric_reader(name: str):
    """The module ``metrics/<name>.py`` (a name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_files(m: dict, cell_name: str, config: Optional[dict] = None,
               traffic: Optional[dict] = None):
    """(cell, config, traffic, limits) of ``cell_name``; ``config`` and
    ``traffic`` replace the files' (the tests' small sizes)."""
    cell = manifest.cell(m, cell_name)
    entry = manifest.config_entry(m, cell["config"])
    config = config if config is not None else load_json(ROOT / entry["file"])
    if traffic is None:
        traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{cell_name}.json")
    return cell, config, traffic, limits


def build_system(config: dict, traffic: dict, seed: int, device):
    module = importlib.import_module(f"perfbench.systems.{config['system']}")
    return module.System(config, traffic, seed, device)


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(system, seconds: float, device) -> Dict[str, float]:
    t0 = time.perf_counter()
    units = system.window(t0 + seconds)
    _sync(device)
    return {"units": units, "seconds": time.perf_counter() - t0}


def traced_parts(system, seconds: float, device) -> dict:
    """The three parts of a traced window, and what each gives the readers."""
    import torch
    from repro_torch.stages import StageTimer
    from perfbench.devtrace import DeviceTrace
    part = seconds / 3
    plain = _timed(system, part, device)
    BUILD.mkdir(exist_ok=True)
    trace_file = BUILD / "perfbench-trace.json"
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        profiled = _timed(system, part, device)
    prof.export_chrome_trace(str(trace_file))
    trace = DeviceTrace.from_file(trace_file)
    trace_file.unlink()
    profiled.update(trace=trace, busy_s=trace.busy_s())
    with StageTimer() as timer:
        staged = _timed(system, part, device)
    staged["ms"] = {k: list(v) for k, v in timer.ms.items()}
    return {"plain": plain, "profile": profiled, "stages": staged}


def run(cell_name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
        config: Optional[dict] = None, traffic: Optional[dict] = None,
        on_system: Optional[Callable] = None, check_modules: bool = True,
        started: Optional[float] = None, out=sys.stdout, err=sys.stderr) -> Optional[dict]:
    """One run; returns the result line's object, or None when no result
    may be printed (a forbidden module was loaded).  ``on_system`` gets the
    system before its set-up (the fault tests plant faults through it);
    ``check_modules=False`` skips the look for forbidden modules (a test
    process that loaded them for other tests)."""
    import torch
    started = process_start() if started is None else started
    m = manifest.load()
    cell, config, traffic, limits = cell_files(m, cell_name, config, traffic)
    system = build_system(config, traffic, seed, device)
    system.log = lambda msg: print(msg, file=err, flush=True)
    if on_system is not None:
        on_system(system)
    print(f"[setup] process start to set-up {time.time() - started:.3f} s", file=err, flush=True)
    system.setup()
    _sync(device)
    setup_s = time.time() - started
    cuda = torch.device(device).type == "cuda"
    if trace:
        parts = traced_parts(system, seconds, device)
    else:
        window = _timed(system, seconds, device)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    metrics: Dict[str, dict] = {}
    result: Dict[str, object] = {}
    if trace:
        ctx = dict(parts, config=config, traffic=traffic, work=system.work(),
                   log=lambda msg: print(msg, file=err, flush=True))
        for x in manifest.metrics_of(m, cell_name, "per_layer"):
            value = metric_reader(x["name"]).read(ctx)
            if value is not None:
                metrics[x["name"]] = {"value": value, "unit": x["unit"]}
        p = parts["profile"]
        result["breakdown"] = {"device_ops": p["trace"].device_ops(),
                               "idle_gaps": p["trace"].idle_gaps()}
    else:
        unit_ms = window["seconds"] / max(window["units"], 1) * 1e3
        e2e = {"setup_s": setup_s, "step_ms": unit_ms, "peak_mem_gb": peak / 1e9}
        for x in manifest.metrics_of(m, cell_name, "end_to_end"):
            metrics[x["name"]] = {"value": e2e[x["name"]], "unit": x["unit"]}

    attempted, failed = system.attempted, system.failed
    system.release()
    t0 = time.perf_counter()
    numbers = system.compare(system.reference())
    print(f"[check] reference {time.perf_counter() - t0:.3f} s", file=err, flush=True)
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = (attempted > 0 and failed == 0
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    found = forbidden_modules() if check_modules else []
    if found:
        print(f"[check] loaded forbidden modules: {found}", file=err, flush=True)
        return None
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        device_info.update(busy_s=parts["profile"]["busy_s"],
                           window_s=parts["profile"]["seconds"])
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device_info}
    line.update(result)
    line["checks"] = checks
    for k, c in checks.items():
        print(f"[check] {k} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(line), file=out, flush=True)
    return line

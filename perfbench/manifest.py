"""``BENCHMARK.json``: loading, the schema it must meet, and the lookups
the harness makes in it (a cell, its configuration, its metrics)."""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"file", "name", "reduced", "source", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def load(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def _line(text, what: str, errors: List[str]) -> None:
    if not isinstance(text, str) or not 1 <= len(text) <= 200 or "\n" in text or "\t" in text:
        errors.append(f"{what}: 1 to 200 characters on one line, no tab")


def validate(m: dict, root: Path = ROOT) -> List[str]:
    """Every way ``m`` breaks the schema; empty when it meets it."""
    errors: List[str] = []
    if set(m) != KEYS:
        return [f"top-level keys {sorted(m)} != {sorted(KEYS)}"]
    cmd, paths = m["command"], m["paths"]
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32):
        errors.append("command: a list of 1 to 32 strings")
    else:
        for word in cmd:
            _line(word, "command word", errors)
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16):
        errors.append("paths: 1 to 16 directories")
        paths = []
    for p in paths:
        if not (isinstance(p, str) and PATH.match(p)) or p.startswith("/") or ".." in p.split("/"):
            errors.append(f"paths: bad directory {p!r}")
    for word in cmd if isinstance(cmd, list) else []:
        if isinstance(word, str) and ("/" in word or word.endswith(".py")):
            if word.startswith("/") or ".." in word.split("/") or not any(
                    word == p or word.startswith(p.rstrip("/") + "/") for p in paths):
                errors.append(f"command names {word!r} outside paths")
    rs = m["run_seconds"]
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        errors.append("run_seconds: a whole number from 1 to 51")

    def name_ok(x, what):
        if not (isinstance(x, str) and NAME.match(x)):
            errors.append(f"{what}: bad name {x!r}")

    def under_paths(f):
        return any(f.startswith(p.rstrip("/") + "/") for p in paths)

    configs = {}
    if not 1 <= len(m["configs"]) <= 24:
        errors.append("configs: 1 to 24")
    files = set()
    for c in m["configs"]:
        if set(c) != CONFIG_KEYS:
            errors.append(f"config {c.get('name')!r}: keys {sorted(c)} != {sorted(CONFIG_KEYS)}")
            continue
        name_ok(c["name"], "config")
        _line(c["source"], f"config {c['name']} source", errors)
        _line(c["why"], f"config {c['name']} why", errors)
        if not under_paths(c["file"]) or not (root / c["file"]).is_file():
            errors.append(f"config {c['name']}: file {c['file']!r} not under paths or missing")
        if c["file"] in files:
            errors.append(f"config {c['name']}: file {c['file']!r} used twice")
        files.add(c["file"])
        if not (isinstance(c["reduced"], list) and len(c["reduced"]) <= 16):
            errors.append(f"config {c['name']}: reduced is a list of at most 16 keys")
        else:
            for k in c["reduced"]:
                name_ok(k, f"config {c['name']} reduced key")
        if c["name"] in configs:
            errors.append(f"config {c['name']}: name used twice")
        configs[c["name"]] = c

    cells = {}
    if not 1 <= len(m["workloads"]) <= 24:
        errors.append("workloads: 1 to 24")
    pairs = set()
    for w in m["workloads"]:
        if set(w) != CELL_KEYS:
            errors.append(f"workload {w.get('name')!r}: keys {sorted(w)} != {sorted(CELL_KEYS)}")
            continue
        for k in ("name", "config", "traffic"):
            name_ok(w[k], f"workload {k}")
        _line(w["why"], f"workload {w['name']} why", errors)
        if w["config"] not in configs:
            errors.append(f"workload {w['name']}: unknown config {w['config']!r}")
        if w["chips"] not in (1, 4):
            errors.append(f"workload {w['name']}: chips 1 or 4")
        if (w["config"], w["traffic"]) in pairs:
            errors.append(f"workload {w['name']}: its config and traffic pair appears twice")
        pairs.add((w["config"], w["traffic"]))
        if w["name"] in cells:
            errors.append(f"workload {w['name']}: name used twice")
        cells[w["name"]] = w
    four = sum(w.get("chips") == 4 for w in m["workloads"])
    if four > max(1, len(m["workloads"]) // 4):
        errors.append("too many cells on 4 chips")
    for c in configs:
        if not any(w.get("config") == c for w in m["workloads"]):
            errors.append(f"config {c}: used by no cell")

    metric_names = set()

    def metric_ok(x, keys, kind):
        extra = set(x) - keys - {"workloads"}
        if not keys <= set(x) or extra:
            errors.append(f"{kind} metric {x.get('name')!r}: keys {sorted(x)}")
            return False
        name_ok(x["name"], f"{kind} metric")
        if x["name"] in metric_names:
            errors.append(f"metric {x['name']}: name used twice")
        metric_names.add(x["name"])
        if not (isinstance(x["unit"], str) and UNIT.match(x["unit"])):
            errors.append(f"metric {x['name']}: bad unit {x['unit']!r}")
        if x["better"] not in ("lower", "higher"):
            errors.append(f"metric {x['name']}: better is lower or higher")
        if x["source"] not in SOURCES:
            errors.append(f"metric {x['name']}: bad source {x['source']!r}")
        for cell in x.get("workloads", []):
            if cell not in cells:
                errors.append(f"metric {x['name']}: unknown workload {cell!r}")
        return True

    e2e = {}
    if not 1 <= len(m["end_to_end"]) <= 16:
        errors.append("end_to_end: 1 to 16")
    for x in m["end_to_end"]:
        if metric_ok(x, E2E_KEYS, "end-to-end"):
            if x["source"] not in ("host_clock", "device_trace"):
                errors.append(f"metric {x['name']}: an end-to-end source is host_clock or "
                              f"device_trace")
            if not (isinstance(x["bound"], (int, float)) and 0.01 <= x["bound"] <= 0.25):
                errors.append(f"metric {x['name']}: bound from 0.01 to 0.25")
            e2e[x["name"]] = x
    if "setup_s" not in e2e:
        errors.append("end_to_end: no setup_s")
    if not 1 <= len(m["per_layer"]) <= 128:
        errors.append("per_layer: 1 to 128")
    layers = []
    for x in m["per_layer"]:
        if metric_ok(x, LAYER_KEYS, "per-layer"):
            _line(x["layer"], f"metric {x['name']} layer", errors)
            if x["moves"] not in e2e:
                errors.append(f"metric {x['name']}: moves unknown metric {x['moves']!r}")
            layers.append(x)

    for cell in cells:
        reports = [n for n, x in e2e.items() if cell in x.get("workloads", cells)]
        if "setup_s" not in reports or len(reports) < 2:
            errors.append(f"workload {cell}: reports setup_s and another end-to-end metric")
        mine = [x for x in layers if cell in x.get("workloads", cells)]
        if not mine:
            errors.append(f"workload {cell}: no per-layer metric")
        for x in mine:
            if x["moves"] not in reports:
                errors.append(f"metric {x['name']} in {cell}: it moves {x['moves']}, "
                              f"which the cell does not report")
    return errors


def cell(m: dict, name: str) -> dict:
    for w in m["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(m: dict, name: str) -> dict:
    return next(c for c in m["configs"] if c["name"] == name)


def metrics_of(m: dict, cell_name: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell_name``
    reports: those without ``workloads``, and those that list it."""
    return [x for x in m[kind] if cell_name in x.get("workloads", [cell_name])]

"""The readings a cell's limits are set from, in one process on the card:

  sound      the program as the configuration states it, a reading a seed
  control    the reference computed in the precision below the one the
             configuration states (float32 -> TF32), put in the program's
             place, on the same inputs
  <fault>    the program with one of ``perfbench.faults`` planted

    python3 perfbench/probe.py --workload gcn-arxiv.train --seeds 11 12 13 \\
        --faults half_batch --fault-seeds 21 22 23

Each reading is printed as a JSON line; the last line sums them up: the
largest sound reading of each number, the smallest control reading and
the smallest reading of each fault.  ``--device cpu`` runs it on the CPU
(a small ``--config`` there).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell_name: str, seed: int, device, config=None, traffic=None, fault=None,
             control: bool = False) -> dict:
    """One seed's numbers: the program's (with ``fault`` planted), and with
    ``control`` the control's too."""
    from perfbench import faults, harness
    from perfbench.compare import detail_train
    m = harness.manifest.load()
    _cell, config, traffic, _limits = harness.cell_files(m, cell_name, config, traffic)
    system = harness.build_system(config, traffic, seed, device)
    undo = faults.plant(system, fault) if fault else (lambda: None)
    try:
        system.setup()
    finally:
        undo()
    system.release()
    want = system.reference()
    out = {"seed": seed, "kind": fault or "sound", "numbers": system.compare(want),
           "detail": detail_train(system.observed, want)}
    if control:
        got = system.control()
        out["control"] = system.compare(want, got=got)
        out["control_detail"] = detail_train(got, want)
    return out


def summary(rows) -> dict:
    out = {}
    for r in rows:
        for kind, numbers in ((r["kind"], r["numbers"]), ("control", r.get("control"))):
            if numbers is None:
                continue
            pick = max if kind == "sound" else min
            slot = out.setdefault(kind, {})
            for k, v in numbers.items():
                slot[k] = v if k not in slot else pick(slot[k], v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default=None, help="a configuration file in place of the cell's")
    ap.add_argument("--traffic", default=None, help="a traffic file in place of the cell's")
    args = ap.parse_args(argv)
    config = json.loads(Path(args.config).read_text()) if args.config else None
    traffic = json.loads(Path(args.traffic).read_text()) if args.traffic else None
    rows = []
    t0 = time.perf_counter()
    for seed in args.seeds:
        rows.append(readings(args.workload, seed, args.device, config, traffic, control=True))
        print(json.dumps(rows[-1]), flush=True)
    for fault in args.faults:
        for seed in args.fault_seeds:
            rows.append(readings(args.workload, seed, args.device, config, traffic, fault=fault))
            print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"workload": args.workload, "seconds": time.perf_counter() - t0,
                      "summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    sys.exit(main())

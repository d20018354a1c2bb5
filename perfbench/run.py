"""Run one cell of ``BENCHMARK.json`` on the CUDA card and print its
result line.

    python3 perfbench/run.py --workload gcn-arxiv.train --seed 7 --seconds 10 --trace 0

Run from the root of a checkout: the program is imported from ``src/``,
and every build and kernel cache goes to ``build/`` there.  Without a
card, or with fewer cards than the cell asks for, it exits 2 and prints
no result; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness, manifest
    started = harness.process_start()
    cell = manifest.cell(manifest.load(), args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {cell['name']} needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        line = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                           started=started)
    except Exception:
        traceback.print_exc()
        return 1
    return 0 if line is not None else 3


if __name__ == "__main__":
    # the checkout's root and its sources, never this folder (whose module
    # names could shadow others); every cache at a fixed path inside it
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv")
    sys.exit(main())

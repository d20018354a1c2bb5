"""Codes-placement sweep, the torch twin of ``benchmarks/codes_offload.py``:
device code bytes O(nodes) under ``codes_placement="device"`` against
O(frontier) under ``"host"``, with the frontier held fixed (batch 32,
fanouts (5, 5), cap 1,024 rows) while the graph grows 8x (2,000 to 16,000
nodes), as the JAX module does.

    PYTHONPATH=src python -m repro_torch.benchmarks.codes_offload [--device cpu] [--smoke]

Runs on the CUDA card unless ``--device cpu``.  Each row is one placement at
one size, ``TRAIN_STEPS`` steps of ``GraphRuntime.train`` through the
prefetch producer.  Columns (the JAX module's, plus the port's own):

  ``device_resident_code_bytes``        bytes of the params' ``codes_buf``
                                        (the port holds a word as int64: 8 B);
                                        0 under host placement
  ``transferred_code_bytes_per_batch``  code bytes the producer moves a
                                        batch (int64 words); 0 under device
                                        placement
  ``uint32_code_bytes_per_batch``       the same rows as the JAX package
                                        counts them (4 B a word)
  ``sample_us`` / ``code_gather_us`` / ``put_us``  the producer's stages,
                                        summed over ``n_produced`` batches

``us_per_call`` is the median step time (host clock, the loss read back;
steps after the first).  The host run's losses must equal the device run's
bit for bit at every size, host code bytes on the card must stay 0 and the
device buffer must grow with the graph, or the run raises.  Prints CSV
only; writes no ``BENCH_*.json``.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np

BATCH = 32
FANOUTS = (5, 5)
FRONTIER_CAP = 1024
SWEEP = (2_000, 4_000, 8_000, 16_000)      # 8x node growth
TRAIN_STEPS = 5


def _spec(n_nodes: int, placement: str):
    from repro_torch.configs.base import EmbeddingSpec, GNNConfig
    from repro_torch.graph.runtime import GraphSource, RuntimeSpec
    emb = EmbeddingSpec(kind="hash_full", c=16, m=8, d_c=64, d_m=64, n_layers=2,
                        lookup_impl="pallas", codes_placement=placement)
    model = GNNConfig(name=f"offload-{n_nodes}", model="sage", n_nodes=n_nodes,
                      n_classes=16, d_e=16, hidden=32, fanouts=FANOUTS, embedding=emb)
    return RuntimeSpec(graph=GraphSource(n_nodes=n_nodes), model=model, batch_size=BATCH,
                       pad_to=64, frontier_cap=FRONTIER_CAP, prefetch_depth=2,
                       total_steps=TRAIN_STEPS)


def device_resident_code_bytes(params) -> int:
    """Bytes of packed code rows in the params on the device."""
    buf = params["embed"].get("codes_buf")
    return 0 if buf is None else buf.numel() * buf.element_size()


def _run_one(n_nodes: int, placement: str, steps: int, device, graph) -> Dict:
    from repro_torch.graph.runtime import GraphRuntime
    rt = GraphRuntime.from_spec(_spec(n_nodes, placement), graph=graph, device=device)
    try:
        resident = device_resident_code_bytes(rt.params)
        res = rt.train(steps)
        stats = rt.data_iter.stats()
    finally:
        rt.close()
    return dict(losses=res.losses, resident=resident, stats=stats,
                step_us=float(np.median(res.step_times[1:] or res.step_times)) * 1e6)


def emit(name: str, us_per_call: float, derived: str) -> None:
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)


def run(device=None, smoke: bool = False) -> List[Dict]:
    """The sweep; returns one row a (size, placement) and prints the CSV."""
    from repro_torch.device import resolve_device
    from repro_torch.graph.runtime import GraphSource
    device = resolve_device(device)
    sweep = SWEEP[:2] if smoke else SWEEP
    steps = 2 if smoke else TRAIN_STEPS
    rows = []
    for n_nodes in sweep:
        graph = GraphSource(n_nodes=n_nodes).build()
        runs = {p: _run_one(n_nodes, p, steps, device, graph) for p in ("device", "host")}
        bitwise = runs["host"]["losses"] == runs["device"]["losses"]
        for placement, r in runs.items():
            st = r["stats"]
            row = dict(name=f"codes_offload/{placement}/n{n_nodes}", device=str(device),
                       n_nodes=n_nodes, frontier_cap=FRONTIER_CAP, codes_placement=placement,
                       device_resident_code_bytes=r["resident"],
                       transferred_code_bytes_per_batch=st["transferred_code_bytes_per_batch"],
                       uint32_code_bytes_per_batch=st["uint32_code_bytes_per_batch"],
                       bitwise_equal_vs_device=bitwise, n_produced=st["n_produced"],
                       sample_us=st["sample_us"], code_gather_us=st["code_gather_us"],
                       put_us=st["put_us"], step_us=r["step_us"],
                       loss_step0=r["losses"][0], loss_last=r["losses"][-1])
            rows.append(row)
            n = max(st["n_produced"], 1)
            emit(row["name"], r["step_us"],
                 f"device={device} resident={r['resident']}B per_batch="
                 f"{st['transferred_code_bytes_per_batch']:.0f}B (uint32 "
                 f"{st['uint32_code_bytes_per_batch']:.0f}B) sample={st['sample_us'] / n:.1f}us "
                 f"code_gather={st['code_gather_us'] / n:.1f}us put={st['put_us'] / n:.1f}us "
                 f"a batch bitwise_{steps}steps={bitwise}")
    host = [r["device_resident_code_bytes"] for r in rows if r["codes_placement"] == "host"]
    dev = [r["device_resident_code_bytes"] for r in rows if r["codes_placement"] == "device"]
    if any(host):
        raise AssertionError(f"host placement left code bytes on the device: {host}")
    if not all(b2 > b1 > 0 for b1, b2 in zip(dev, dev[1:])):
        raise AssertionError(f"the device buffer did not grow with the graph: {dev}")
    if not all(r["bitwise_equal_vs_device"] for r in rows):
        raise AssertionError(f"host placement diverged from device placement within "
                             f"{steps} steps")
    emit("codes_offload/summary", 0.0,
         f"host resident 0B over {sweep[0]}->{sweep[-1]} nodes; device grows "
         f"{dev[0]}->{dev[-1]}B; bitwise=True")
    return rows


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' to run here")
    ap.add_argument("--smoke", action="store_true", help="two sizes, two steps")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    run(args.device, args.smoke)


if __name__ == "__main__":
    main()

"""The production dry run without the production machine (counterpart of
``repro/launch/dryrun.py``).

For every (architecture x input shape x mesh) cell: build one rank's step
(train / prefill / serve) of the production mesh (16 x 16, or 2 x 16 x 16)
under the sharding policy, and trace it once under ``FakeTensorMode`` on a
``VirtualMesh`` (the rank at coordinate 0, no process group: each
collective returns a new tensor of its output's shape and is counted),
with ``launch.opanalysis.OpAnalyzer`` counting its ops.  A cell that
traces proves what the JAX dry run's lowering proves for the port's
explicit SPMD: every layout change of the step has its collective, every
block its shape, and the rank's memory is known.  Tensors without storage
have no ``data_ptr``, so the kernels run as their plain versions: the
tool is device-free by design, as JAX's dry run on host devices is, and
is no fallback on the main path.

Each cell writes one JSON record with JAX's keys where they mean the same
thing (``status``, ``microbatches``, ``memory.peak_est_gib`` and
``memory.argument_gib``, ``hbm_model``, ``roofline``); what only XLA gives
is not faked, and the record names its own counterparts instead
(``trace_s`` for ``lower_s`` / ``compile_s``, ``op_bytes_unfused`` for
``hlo_bytes_unfused``, ``mesh_stats``: the bytes the rank receives by
axes and operation, as a live ``Mesh`` counts them) with
``"device": "fake"``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--multi-pod | --both-meshes] [--embedding-kind dense|hash_full]
      [--out results/dryrun_torch] [--microbatches N] [--profile optimized]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.archs import ASSIGNED
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES, cell_is_applicable, input_specs
from repro_torch.parallel.policy import DEFAULT_STRATEGY, Strategy

# per-arch default gradient accumulation for train_4k: the JAX package's
DEFAULT_MICROBATCHES = {
    "qwen1.5-0.5b": 2, "chatglm3-6b": 8, "internlm2-20b": 16, "yi-9b": 8,
    "musicgen-large": 4, "mamba2-2.7b": 8, "zamba2-7b": 8, "dbrx-132b": 16,
    "granite-moe-3b-a800m": 4, "qwen2-vl-7b": 8,
}
GIB = 2 ** 30


def cell_microbatches(shape, mesh, microbatches: int,
                      strategy: Strategy = DEFAULT_STRATEGY) -> int:
    """JAX's halving loop: a train cell's microbatch count halved until the
    batch divides by it and each microbatch by the data-parallel extent."""
    mb = microbatches
    if shape.kind == "train":
        dp = int(np.prod([mesh.shape[a] for a in strategy.batch_mesh_axes(mesh)]))
        while mb > 1 and (shape.batch % mb or (shape.batch // mb) % dp):
            mb //= 2
    return mb


def _tensors(tree):
    """Every tensor of a nest of dicts, lists, tuples and dataclasses."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


@dataclasses.dataclass
class Cell:
    """One rank's step of a cell on ``mesh`` (a ``MeshSpec``), built
    afresh by each ``trace``."""
    cfg: Any
    shape: Any
    mesh: Any
    microbatches: int
    strategy: Strategy = DEFAULT_STRATEGY
    moments_dtype: str = "float32"
    rank: int = 0
    s_max: Optional[int] = None         # a prefill's cache slots (``shape.seq`` by default)

    def _build(self, vmesh):
        """(the step's arguments, the step) on the virtual rank; inside
        ``FakeTensorMode``."""
        from repro_torch.core.backend import torch_dtype
        from repro_torch.models.lm import init_cache, init_lm
        from repro_torch.optim.adamw import AdamWConfig
        from repro_torch.train.step import (TrainHyper, _block_keeper, init_train_state,
                                            make_prefill_step, make_serve_step,
                                            make_train_step)
        cfg, shape, strategy = self.cfg, self.shape, self.strategy
        gen = torch.Generator()
        batch = {k: torch.zeros(v.shape, dtype=v.dtype)
                 for k, v in input_specs(cfg, shape).items()}
        if shape.kind == "train":
            state = init_train_state(gen, cfg, moments_dtype=getattr(torch, self.moments_dtype),
                                     mesh=vmesh, strategy=strategy)
            hyper = TrainHyper(microbatches=self.microbatches, optimizer=AdamWConfig(
                lr=1e-3, weight_decay=0.01, clip_norm=1.0))
            return (state, batch), make_train_step(cfg, hyper, mesh=vmesh, strategy=strategy)
        params = init_lm(gen, cfg, keep=_block_keeper(cfg, vmesh, strategy))
        if shape.kind == "prefill":
            return (params, batch), make_prefill_step(cfg, self.s_max or shape.seq, mesh=vmesh,
                                                      strategy=strategy)
        # decode: one new token against a cache that holds seq - 1
        cache = init_cache(cfg, shape.batch, shape.seq, torch_dtype(cfg.compute_dtype),
                           mesh=vmesh, strategy=strategy)
        cache.pos = shape.seq - 1
        return (params, cache, batch), make_serve_step(cfg, mesh=vmesh, strategy=strategy)

    def trace(self) -> Dict[str, Any]:
        """Build and run the step once: the counter's totals, the bytes of
        the arguments and the peak, the virtual mesh's ``stats`` and calls,
        the wall time."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.launch.opanalysis import OpAnalyzer
        from repro_torch.parallel.sharding import VirtualMesh
        vmesh = VirtualMesh(self.mesh, self.rank)
        t0 = time.perf_counter()
        with FakeTensorMode():
            args, step = self._build(vmesh)
            vmesh.stats.clear()
            vmesh.calls.clear()
            counter = OpAnalyzer()
            arg_bytes = counter.hold(_tensors(args))
            t1 = time.perf_counter()
            with counter:
                out = step(*args)
            del out
        t2 = time.perf_counter()
        return {"analysis": counter.totals(vmesh), "argument_bytes": arg_bytes,
                "peak_bytes": counter.peak_bytes, "ops": counter.ops,
                "stats": {k: v for k, v in vmesh.stats.items() if not k.endswith("_calls")},
                "calls": list(vmesh.calls), "build_s": t1 - t0, "trace_s": t2 - t1}


def build_cell(cfg, shape, mesh, microbatches: int, strategy: Strategy = DEFAULT_STRATEGY,
               moments_dtype: str = "float32", rank: int = 0, s_max: Optional[int] = None) -> Cell:
    """One rank's step of the cell on any ``mesh`` (a ``MeshSpec`` or a
    live ``Mesh``'s spec) under the policy, ready to ``trace``; ``s_max``:
    a prefill's cache slots, when they are more than its prompt's."""
    spec = getattr(mesh, "spec", mesh)
    return Cell(cfg, shape, spec, microbatches, strategy, moments_dtype, rank, s_max)


def cell_record(cfg, shape, mesh, traced: Dict[str, Any], mb: int,
                strategy: Strategy = DEFAULT_STRATEGY) -> Dict[str, Any]:
    """A traced cell's record fields (JAX's keys where they mean the same)."""
    from repro_torch.launch.hbm_model import analytic_hbm_bytes
    a = traced["analysis"]
    hbm = analytic_hbm_bytes(cfg, shape, mesh, microbatches=mb if shape.kind == "train" else 1,
                             strategy=strategy)
    terms = roofline.RooflineTerms(
        flops=a.flops, bytes_accessed=hbm["total"], coll_bytes=sum(a.coll.values()),
        coll_breakdown=dict(a.coll),
        model_flops_per_chip=roofline.model_flops(cfg, shape, mesh.size), chips=mesh.size)
    arg, peak = traced["argument_bytes"], traced["peak_bytes"]
    return {
        "status": "ok",
        "device": "fake",
        "microbatches": mb if shape.kind == "train" else None,
        "build_s": round(traced["build_s"], 2),
        "trace_s": round(traced["trace_s"], 2),
        "ops": traced["ops"],
        "counted_flops": a.flops,
        "op_bytes_unfused": a.hbm_bytes,        # every aten op's operands and results
        "hbm_model": hbm,                       # analytic fused traffic
        "mesh_stats": traced["stats"],          # bytes the rank receives, axes/operation
        "memory": {"argument_gib": arg / GIB, "temp_gib": (peak - arg) / GIB,
                   "peak_est_gib": peak / GIB},
        "roofline": terms.as_dict(),
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, embedding_kind=None,
             microbatches=None, overrides=None, strategy: Strategy = DEFAULT_STRATEGY,
             moments_dtype: str = "float32") -> dict:
    cfg = get_config(arch, **(overrides or {}))
    if embedding_kind is not None and cfg.embedding.kind != embedding_kind:
        if not (embedding_kind != "dense" and arch == "musicgen-large"):
            cfg = dataclasses.replace(
                cfg, embedding=dataclasses.replace(cfg.embedding, kind=embedding_kind))
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "embedding_kind": cfg.embedding.kind, "strategy": dataclasses.asdict(strategy)}
    if not cell_is_applicable(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = ("long_500k requires sub-quadratic attention; "
                         f"{arch} is pure full-attention (DESIGN.md §4)")
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    mb = cell_microbatches(shape, mesh, microbatches or DEFAULT_MICROBATCHES.get(arch, 1),
                           strategy)
    try:
        traced = build_cell(cfg, shape, mesh, mb, strategy, moments_dtype).trace()
    except Exception as e:  # a failure here is a bug in the port
        rec["status"] = "FAILED"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        return rec
    rec.update(cell_record(cfg, shape, mesh, traced, mb, strategy))
    return rec


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--embedding-kind", default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--moments-dtype", default="float32")
    ap.add_argument("--moe-impl", default=None)
    ap.add_argument("--profile", choices=["baseline", "optimized"], default="baseline")
    ap.add_argument("--strategy", default=None,
                    help="JSON Strategy overrides, e.g. '{\"dp_over_model\": true}'")
    ap.add_argument("--tag", default="", help="suffix for output filenames")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    strategy = DEFAULT_STRATEGY
    if args.strategy:
        strategy = Strategy(**json.loads(args.strategy))

    archs = [args.arch] if args.arch else ASSIGNED
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    print(f"counter calibration (per-chip ratio): "
          f"{roofline.calibrate_counter(make_production_mesh()):.3f}", flush=True)

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                kw = dict(embedding_kind=args.embedding_kind, microbatches=args.microbatches,
                          strategy=strategy, moments_dtype=args.moments_dtype,
                          overrides={"moe_impl": args.moe_impl} if args.moe_impl else None)
                if args.profile == "optimized":
                    from repro_torch.launch.profiles import optimized_cell_settings
                    opt = optimized_cell_settings(arch, SHAPES[shape_name].kind)
                    if opt:
                        kw["strategy"] = opt.get("strategy", kw["strategy"])
                        kw["microbatches"] = opt.get("microbatches", kw["microbatches"])
                        kw["moments_dtype"] = opt.get("moments_dtype", kw["moments_dtype"])
                        if opt.get("overrides"):
                            kw["overrides"] = {**(kw["overrides"] or {}), **opt["overrides"]}
                rec = run_cell(arch, shape_name, mp, **kw)
                tag = f"{arch}__{shape_name}__{rec['mesh']}"
                if args.embedding_kind:
                    tag += f"__{args.embedding_kind}"
                if args.tag:
                    tag += f"__{args.tag}"
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                if rec["status"] == "ok":
                    n_ok += 1
                    r = rec["roofline"]
                    print(f"OK   {tag:60s} trace={rec['trace_s']:7.1f}s "
                          f"mem={rec['memory']['peak_est_gib']:6.2f}GiB "
                          f"dom={r['dominant']:10s} "
                          f"terms(c/m/x)=({r['compute_s']:.4f}/{r['memory_s']:.4f}/"
                          f"{r['collective_s']:.4f})s frac={r['roofline_fraction']:.3f}",
                          flush=True)
                elif rec["status"] == "skipped":
                    n_skip += 1
                    print(f"SKIP {tag:60s} {rec['reason'][:70]}", flush=True)
                else:
                    n_fail += 1
                    print(f"FAIL {tag:60s} {rec['error'][:120]}", flush=True)
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_fail} FAILED", flush=True)
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())

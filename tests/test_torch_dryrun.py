"""The dry run and its counter (``repro_torch.launch.dryrun``,
``launch.opanalysis``, ``roofline.collective_bytes`` /
``calibrate_counter``, ``parallel.sharding.VirtualMesh``) against the JAX
package's dry run and against a live 4-rank run.

  * ``ASSIGNED`` and ``DEFAULT_MICROBATCHES`` equal JAX's; for every arch,
    shape and mesh the microbatch count after the halving loop and the
    skipped cells equal what JAX's ``run_cell`` reaches (read in a
    subprocess with its 512 host devices, its ``build_cell`` stubbed so
    nothing compiles);
  * ``calibrate_counter`` is exactly 1.0 at (2, 2), 16 x 16 and 2 x 16 x 16;
  * the counter's FLOPs for a reduced qwen forward equal the analytic
    count of its matmuls exactly;
  * the virtual mesh's ``stats`` for a reduced qwen train step on (2, 2)
    equal a live 4-rank gloo run's, key for key and byte for byte, and its
    calls' wire bytes equal the stats' sum;
  * a traced cell's record has JAX's keys and the port's own, and the CLI
    writes one record a cell; ``collective_bytes`` has JAX's keys.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES, ShapeSpec, cell_is_applicable
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import MeshSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QWEN = "qwen1.5-0.5b"
MESH22 = MeshSpec(("data", "model"), (2, 2))
TRAIN = ShapeSpec("reduced_train", "train", 16, 8)

# JAX's run_cell with its build_cell stubbed: the microbatch count it
# reaches (in the stub's error) or its skip, for every cell
_JAX_CELLS = r'''
import json, sys
import repro.launch.dryrun as d      # sets 512 forced host devices before jax starts
from repro.launch.shapes import SHAPES

def stub(cfg, shape, mesh, microbatches, strategy, moments_dtype):
    raise RuntimeError(f"MB={microbatches}")

d.build_cell = stub
out = {}
for arch in d.ASSIGNED:
    for shape in SHAPES:
        for mp in (False, True):
            rec = d.run_cell(arch, shape, mp)
            key = f"{arch}|{shape}|{rec['mesh']}"
            if rec["status"] == "skipped":
                out[key] = "skipped"
            else:
                out[key] = int(rec["error"].split("MB=")[1])
print(json.dumps({"cells": out, "mb": d.DEFAULT_MICROBATCHES, "assigned": d.ASSIGNED}))
'''


@pytest.fixture(scope="module")
def jax_cells():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _JAX_CELLS], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_assigned_and_default_microbatches_are_jax_s(jax_cells):
    from repro.configs.archs import ASSIGNED as J_ASSIGNED
    from repro_torch.configs.archs import ASSIGNED
    assert ASSIGNED == J_ASSIGNED == jax_cells["assigned"]
    assert dryrun.DEFAULT_MICROBATCHES == jax_cells["mb"]
    # and the JAX module's source literally
    src = open(os.path.join(REPO, "src", "repro", "launch", "dryrun.py")).read()
    node = next(n for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "DEFAULT_MICROBATCHES")
    assert ast.literal_eval(node.value) == dryrun.DEFAULT_MICROBATCHES


def test_halving_and_skips_equal_jax_s(jax_cells):
    from repro_torch.configs.archs import ASSIGNED
    got = {}
    for arch in ASSIGNED:
        cfg = get_config(arch)
        for name, shape in SHAPES.items():
            for mp in (False, True):
                mesh = make_production_mesh(multi_pod=mp)
                key = f"{arch}|{name}|{'2x16x16' if mp else '16x16'}"
                if not cell_is_applicable(cfg, shape):
                    got[key] = "skipped"
                    continue
                got[key] = dryrun.cell_microbatches(
                    shape, mesh, dryrun.DEFAULT_MICROBATCHES.get(arch, 1))
    assert got == jax_cells["cells"]
    assert sum(v == "skipped" for v in got.values()) == 16
    assert len(got) == 80


@pytest.mark.parametrize("mesh", [MESH22, make_production_mesh(),
                                  make_production_mesh(multi_pod=True)],
                         ids=["2x2", "16x16", "2x16x16"])
def test_calibrate_counter_is_exactly_one(mesh):
    assert roofline.calibrate_counter(mesh) == 1.0


def _analytic_forward_flops(cfg, B, S):
    """2 x M x K x N of every matmul of a reduced dense forward: the hash
    decode off the card (its one-hot (T, m c) x (m c, d_c) product), the
    decoder's MLP over every token, q / k / v / o, the two attention
    products, the MLP, the head."""
    T = B * S
    ecfg = cfg.embedding_config().decoder_config()
    from repro_torch.core.decoder import mlp_dims
    total = 2 * T * ecfg.m * ecfg.c * ecfg.d_c
    total += sum(2 * T * i * o for i, o in mlp_dims(ecfg))
    D, H, K, Dh, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    per_layer = 2 * T * D * (H * Dh + 2 * K * Dh) + 2 * T * H * Dh * D
    per_layer += 2 * (2 * B * H * S * S * Dh)            # scores and the weighted sum
    per_layer += 2 * T * D * F * 3 if cfg.act == "swiglu" else 2 * T * D * F * 2
    total += cfg.n_layers * per_layer
    total += 2 * T * D * cfg.vocab_padded
    return total


def test_counter_flops_of_a_reduced_forward_are_the_analytic_count():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.opanalysis import OpAnalyzer
    from repro_torch.models.lm import init_lm, lm_forward
    cfg = reduced(get_config(QWEN))
    B, S = 2, 16
    with FakeTensorMode():
        params = init_lm(torch.Generator(), cfg)
        tokens = torch.zeros((B, S), dtype=torch.int64)
        with OpAnalyzer() as counter:
            lm_forward(params, tokens, cfg)
    assert counter.flops == _analytic_forward_flops(cfg, B, S)
    assert counter.ops > 0 and counter.hbm_bytes > 0


def _live_step_stats(rank):
    """One reduced qwen train step on the live (2, 2) mesh: the bytes the
    rank received during the step, by axes and operation."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import TrainHyper, init_train_state, make_train_step
    mesh = make_host_mesh(2, 2, device="cpu")
    cfg = reduced(get_config(QWEN))
    state = init_train_state(torch.Generator().manual_seed(0), cfg, mesh=mesh)
    step = make_train_step(cfg, TrainHyper(optimizer=AdamWConfig(
        lr=1e-3, weight_decay=0.01, clip_norm=1.0)), mesh=mesh)
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (TRAIN.batch, TRAIN.seq))
    before = dict(mesh.stats)
    step(state, {"tokens": tok, "labels": tok})
    return {k: v - before.get(k, 0) for k, v in mesh.stats.items()
            if not k.endswith("_calls") and v - before.get(k, 0)}


def test_virtual_mesh_stats_equal_a_live_run():
    live = sharding.spawn(_live_step_stats, 4, backend="gloo", timeout_s=300)
    cfg = reduced(get_config(QWEN))
    for rank in (0, 3):
        traced = dryrun.build_cell(cfg, TRAIN, MESH22, 1, rank=rank).trace()
        stats = {k: v for k, v in traced["stats"].items() if v}
        assert stats == live[rank], rank
        wire = roofline.collective_bytes(traced["calls"])
        assert wire["total"] == sum(stats.values())


def test_cell_record_keys(tmp_path):
    cfg = reduced(get_config(QWEN))
    traced = dryrun.build_cell(cfg, TRAIN, MESH22, 2).trace()
    rec = dryrun.cell_record(cfg, TRAIN, MESH22, traced, 2)
    for key in ("status", "microbatches", "hbm_model", "roofline", "memory", "device",
                "trace_s", "op_bytes_unfused", "mesh_stats", "counted_flops"):
        assert key in rec, key
    assert rec["status"] == "ok" and rec["device"] == "fake" and rec["microbatches"] == 2
    assert rec["memory"]["peak_est_gib"] >= rec["memory"]["argument_gib"] > 0
    assert set(rec["roofline"]) == set(roofline.RooflineTerms(
        0, 0, 0, {}, 0, 1).as_dict())
    assert rec["roofline"]["flops_per_chip"] == rec["counted_flops"] > 0
    assert "total" in rec["hbm_model"]
    # the CLI: one production decode cell, its record on disk
    out = tmp_path / "dry"
    assert dryrun.main(["--arch", QWEN, "--shape", "decode_32k", "--out", str(out)]) == 0
    with open(out / f"{QWEN}__decode_32k__16x16.json") as f:
        disk = json.load(f)
    assert disk["status"] == "ok" and disk["mesh"] == "16x16"
    assert disk["memory"]["peak_est_gib"] > 0 and disk["mesh_stats"]


def test_collective_bytes_has_jax_s_keys():
    from repro.launch.roofline import collective_bytes as j_collective_bytes
    got = roofline.collective_bytes([("all-gather", "data", 400, 4),
                                     ("all-to-all", "model", 100, 2),
                                     ("collective-permute", "model", 8, 4)])
    assert set(got) == set(j_collective_bytes(""))
    assert got["all-gather"] == 300 and got["all-to-all"] == 50
    assert got["collective-permute"] == 8 and got["total"] == 358

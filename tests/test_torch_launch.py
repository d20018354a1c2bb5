"""Port parity for ``launch.shapes``, ``launch.roofline`` and
``launch.mesh`` against the JAX package on the CPU.

The shape set, ``cell_is_applicable``, ``input_specs``' shapes and dtypes,
``model_flops`` and the hash-decode byte model equal JAX's exactly for every
architecture, shape and dtype; ``decode_roofline``'s counts equal JAX's,
and its times are those counts over the H100 constants (NVIDIA's data
sheet), not JAX's TPU v5e ones.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.launch import roofline as j_roofline
from repro.launch import shapes as j_shapes
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import mesh, roofline, shapes

ARCHS = j_list_archs()
DECODE_CASES = [(61_696, 256, 16, 512, "float32", False), (8, 256, 16, 512, "float32", False),
                (169_343, 256, 16, 512, "float32", False), (8_192, 256, 16, 512, "bfloat16", False),
                (24_832, 256, 16, 512, "int8", True), (512, 16, 8, 64, "bfloat16", True)]


def test_h100_constants():
    """The data sheet's NVIDIA H100 80GB HBM3 (SXM, 700 W) rates."""
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.F32_FLOPS, mesh.NVLINK_BW) == \
        (989e12, 3.35e12, 67e12, 450e9)
    assert list_archs() == ARCHS and len(ARCHS) == 10


def test_shape_set_matches_jax():
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in j_shapes.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", list(j_shapes.SHAPES))
def test_cells_and_input_specs_match_jax(arch, shape):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    jshape, tshape = j_shapes.SHAPES[shape], shapes.SHAPES[shape]
    assert shapes.cell_is_applicable(tcfg, tshape) == j_shapes.cell_is_applicable(jcfg, jshape)
    jspecs = j_shapes.input_specs(jcfg, jshape)
    tspecs = shapes.input_specs(tcfg, tshape)
    assert list(tspecs) == list(jspecs)
    for name, spec in tspecs.items():
        assert spec.device.type == "meta" and spec.dtype == torch.int32
        assert tuple(spec.shape) == tuple(jspecs[name].shape), name
        assert jspecs[name].dtype == jnp.int32


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_jax_exactly(arch):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    for name in j_shapes.SHAPES:
        for chips in (1, 4):
            assert roofline.model_flops(tcfg, shapes.SHAPES[name], chips) == \
                j_roofline.model_flops(jcfg, j_shapes.SHAPES[name], chips)
    # a cut depth and chip_smoke.py's LM training step shape
    small = shapes.ShapeSpec("lm_step", "train", 2048, 4)
    assert roofline.model_flops(dataclasses.replace(tcfg, n_layers=14), small, 1) == \
        j_roofline.model_flops(dataclasses.replace(jcfg, n_layers=14),
                               j_shapes.ShapeSpec("lm_step", "train", 2048, 4), 1)


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_decode_bytes_and_roofline_match_jax(case):
    B, c, m, d_c, dtype, w0 = case
    assert roofline.decode_hbm_bytes(B, c, m, d_c, dtype, w0) == \
        j_roofline.decode_hbm_bytes(B, c, m, d_c, dtype, w0)
    assert roofline.DECODE_DTYPE_BYTES == j_roofline.DECODE_DTYPE_BYTES
    mine = roofline.decode_roofline(B, c, m, d_c, dtype, w0, measured_us=10.0)
    theirs = j_roofline.decode_roofline(B, c, m, d_c, dtype, w0, measured_us=10.0)
    for key in ("flops", "hbm_bytes", "hbm_bytes_codebooks", "arithmetic_intensity"):
        assert mine[key] == theirs[key], key
    compute_us = mine["flops"] / mesh.PEAK_FLOPS_BF16 * 1e6
    memory_us = mine["hbm_bytes"] / mesh.HBM_BW * 1e6
    assert mine["compute_us"] == pytest.approx(compute_us, rel=1e-12)
    assert mine["memory_us"] == pytest.approx(memory_us, rel=1e-12)
    assert mine["step_us"] == max(mine["compute_us"], mine["memory_us"])
    assert mine["bound"] == ("compute" if compute_us >= memory_us else "memory")
    assert mine["achieved_vs_roofline"] == pytest.approx(mine["step_us"] / 10.0)
    assert mine["roofline_fraction"] == pytest.approx(
        mine["flops"] / (mesh.PEAK_FLOPS_BF16 * mine["step_us"] * 1e-6), rel=1e-12)


def test_serve_decode_bound_on_the_h100():
    """The serving frontier's byte bound (61,696 rows, f32): 0.0414 ms."""
    memory_ms = roofline.decode_roofline(61_696, 256, 16, 512)["memory_us"] / 1e3
    assert round(memory_ms, 4) == 0.0414


def test_roofline_terms_on_the_h100():
    terms = roofline.RooflineTerms(flops=2e15, bytes_accessed=6.7e11, coll_bytes=9e10,
                                   coll_breakdown={"all-reduce": 9e10},
                                   model_flops_per_chip=1.5e15, chips=4)
    assert terms.compute_s == 2e15 / 989e12
    assert terms.memory_s == 6.7e11 / 3.35e12
    assert terms.collective_s == 9e10 / 450e9
    assert terms.dominant == "compute" and terms.step_s == terms.compute_s
    assert terms.useful_ratio == 0.75
    assert terms.roofline_fraction == pytest.approx(1.5e15 / 2e15)
    d = terms.as_dict()
    assert d["dominant"] == "compute" and d["chips"] == 4 and set(d) >= {
        "compute_s", "memory_s", "collective_s", "step_s", "roofline_fraction"}
    assert roofline.RooflineTerms(0, 0, 0, {}, 0, 1).roofline_fraction == 0.0

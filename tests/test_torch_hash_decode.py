"""Port parity: the ``hash_decode`` kernel's plain version and wrapper
(``repro_torch.kernels.hash_decode``) against the JAX package.

Reference runs: ``repro.core.backend.GatherBackend`` (the m-term gather-sum
in codebook order) and the Pallas kernel in interpret mode through
``PallasBackend(interpret=True)``, which pads ragged shapes as it must on a
TPU.  The plain version repeats the gather's f32 adds in the same order,
so it must match it bitwise; against the Pallas one-hot matmul the bound is
the 2e-4 of ``tests/test_kernels.py``.  The CUDA kernel itself runs only on
a card: ``tests/test_torch_gpu.py`` holds it against the plain version.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jbackend
from repro.kernels.hash_decode import ops as j_ops
from repro_torch.kernels.hash_decode import ops as t_ops
from repro_torch.kernels.hash_decode.ref import hash_decode_ref

SHAPES = [(256, 16, 256, 512), (128, 128, 2, 512), (100, 8, 16, 96)]
VARIANTS = ["float32", "float32+w0", "bfloat16", "bfloat16+w0", "int8", "int8+w0"]


def _inputs(B, m, c, d_c, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, c, (B, m)).astype(np.int32)
    cb = rng.standard_normal((m, c, d_c)).astype(np.float32)
    w0 = rng.standard_normal(d_c).astype(np.float32)
    return codes, cb, w0


def _port(codes, cb, w0, variant):
    """The port's plain version on the variant's storage (torch tensors)."""
    dtype, _, with_w0 = variant.partition("+")
    cb_t = torch.from_numpy(cb)
    scales = None
    if dtype == "bfloat16":
        cb_t = cb_t.to(torch.bfloat16)
    elif dtype == "int8":
        cb_t, scales = t_ops.quantize_codebooks(cb_t)
    w = torch.from_numpy(w0) if with_w0 else None
    if w is not None and dtype == "bfloat16":
        w = w.to(torch.bfloat16).float()     # bf16-stored w0, widened as the kernel takes it
    return torch.from_numpy(codes), cb_t, w, scales


def _jax(backend_cls, codes, cb, w0, variant, **kw):
    dtype, _, with_w0 = variant.partition("+")
    policy = jbackend.MixedPrecisionPolicy(
        param_dtype="bfloat16" if dtype == "bfloat16" else None,
        quantize="int8" if dtype == "int8" else "none")
    be = backend_cls(policy=policy, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # Pallas padding / tile fallbacks
        out = be.decode(jnp.asarray(codes), jnp.asarray(cb),
                        jnp.asarray(w0) if with_w0 else None)
    return np.asarray(out)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_version_matches_jax_gather_bitwise(shape, variant):
    codes, cb, w0 = _inputs(*shape)
    got = hash_decode_ref(*_port(codes, cb, w0, variant))
    assert got.dtype == torch.float32 and tuple(got.shape) == (shape[0], shape[3])
    np.testing.assert_array_equal(
        got.numpy(), _jax(jbackend.GatherBackend, codes, cb, w0, variant))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_wrapper_on_cpu_matches_pallas_interpret(shape, variant):
    codes, cb, w0 = _inputs(*shape, seed=1)
    before = t_ops.hash_decode.launches
    got = t_ops.hash_decode(*_port(codes, cb, w0, variant))
    assert t_ops.hash_decode.launches == before      # CPU: plain version, no launch
    ref = _jax(jbackend.PallasBackend, codes, cb, w0, variant, interpret=True)
    # the Pallas kernel sums one-hot matmul products; 2e-4 as in test_kernels.py
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape", [(4, 256, 512), (16, 2, 96), (3, 5, 7)])
def test_quantize_codebooks_bitwise(shape):
    cb = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    cb[0, 0] = 0.0                                   # all-zero vector -> scale 1
    jq, js = j_ops.quantize_codebooks(jnp.asarray(cb))
    tq, ts = t_ops.quantize_codebooks(torch.from_numpy(cb))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        t_ops.dequantize_codebooks(tq, ts).numpy(),
        np.asarray(j_ops.dequantize_codebooks(jq, js)))


def test_wrapper_rejects_bad_operands():
    codes, cb, w0 = (torch.from_numpy(a) for a in _inputs(8, 4, 16, 32))
    with pytest.raises(TypeError):
        t_ops.hash_decode(codes.long(), cb)
    with pytest.raises(ValueError):
        t_ops.hash_decode(codes[:, :3].contiguous(), cb)
    with pytest.raises(ValueError):
        t_ops.hash_decode(codes, cb.to(torch.int8))            # int8 needs scales
    with pytest.raises(TypeError):
        t_ops.hash_decode(codes, cb, w0.double())
    # a strided operand computes as the contiguous one (on the CPU the plain
    # version reads it as it is; on the card the wrapper copies it)
    assert torch.equal(t_ops.hash_decode(codes.t().contiguous().t(), cb),
                       t_ops.hash_decode(codes, cb))


@pytest.mark.parametrize("shape,expect", [
    # serving, f32: 64 slices of 8 features x 2 row ranges on 132 SMs
    ((61_696, 16, 256, 512, 4, False), ("staged", 128, 1024, 131_072, 64, 30_848, 0)),
    # training, bf16: 32 slices of 16 features x 4 row ranges
    ((8_192, 16, 256, 512, 2, False), ("staged", 128, 1024, 131_072, 32, 2_048, 0)),
    # reconstruction's batch of 512, below STAGED_MIN_ROWS: the direct variant
    ((512, 16, 256, 512, 4, False), ("direct", 256, 256, 128, 0, 2, 128)),
    # int8, d_c = 130 (5 slices of 32, the last ragged) and the scales table
    ((61_696, 16, 256, 130, 1, True), ("staged", 130, 512, 147_456, 5, 2_373, 0)),
], ids=["serve-f32", "train-bf16", "reconstruct-f32", "int8-ragged"])
def test_launch_shape(shape, expect):
    assert tuple(t_ops.launch_shape(*shape, sms=132)) == expect
    assert expect[3] <= t_ops.SMEM_LIMIT


def test_launch_shape_falls_back_to_direct_and_forces_variants():
    """A slice of m * c codebook rows above the shared-memory limit takes the
    direct variant; either variant can be forced where it fits."""
    big = t_ops.launch_shape(61_696, 32, 256, 512, 4, False, sms=132)
    assert big.variant == "direct" and big.smem == 2 * 32 * 4
    with pytest.raises(ValueError, match="shared memory"):
        t_ops.launch_shape(61_696, 32, 256, 512, 4, False, sms=132, variant="staged")
    assert t_ops.launch_shape(512, 16, 256, 512, 4, False, 132, "staged").variant == "staged"
    assert t_ops.launch_shape(61_696, 16, 256, 512, 4, False, 132, "direct").variant == "direct"
    small = t_ops.launch_shape(t_ops.STAGED_MIN_ROWS, 16, 256, 512, 4, False, sms=132)
    assert small.variant == "staged" and small.grid <= 132


def test_cached_build_returns_its_compiler_log(tmp_path, monkeypatch):
    """A library built earlier is not rebuilt, and its ``-Xptxas -v`` log
    (kept beside it) is returned again; without the log it is rebuilt."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    lib = build.library_path(t_ops.NAME, t_ops.SOURCE)
    lib.write_bytes(b"")
    lib.with_suffix(".log").write_text("ptxas info    : Used 32 registers\n")
    assert build.build_shared_library(t_ops.NAME, t_ops.SOURCE) == (
        lib, "ptxas info    : Used 32 registers\n")
    lib.with_suffix(".log").unlink()
    monkeypatch.setattr(build, "find_nvcc", lambda: "/bin/false")
    with pytest.raises(RuntimeError, match="building hash_decode failed"):
        build.build_shared_library(t_ops.NAME, t_ops.SOURCE)



# ---------------- the backward's sort and its plain version ----------------

def _codes(kind, B, m, c, seed=0):
    from repro_torch.kernels.hash_decode.ref import code_set
    return code_set(kind, B, m, c, np.random.default_rng(seed))


@pytest.mark.parametrize("kind,B,m,c", [("uniform", 300, 4, 16), ("clamped", 257, 3, 16),
                                        ("clamped", 0, 3, 16), ("clamped", 1, 3, 16),
                                        ("one_code", 500, 3, 8), ("zipf", 1000, 2, 256),
                                        ("uniform", 40, 2, 1)])
def test_code_order_is_a_stable_argsort_by_clamped_code(kind, B, m, c):
    """``ref.code_order`` (and the wrapper on CPU codes): for each codebook,
    numpy's stable argsort of the clamped codes, and each code's offsets."""
    codes = _codes(kind, B, m, c)
    offsets, rows = t_ops.code_order(torch.from_numpy(codes), c)
    assert offsets.dtype == rows.dtype == torch.int32
    assert tuple(offsets.shape) == (m, c + 1) and tuple(rows.shape) == (m, B)
    for j in range(m):
        k = np.clip(codes[:, j], 0, c - 1)
        np.testing.assert_array_equal(rows[j].numpy(), np.argsort(k, kind="stable"))
        np.testing.assert_array_equal(
            offsets[j].numpy(), np.concatenate([[0], np.cumsum(np.bincount(k, minlength=c))]))


@pytest.mark.parametrize("kind,B,m,c,d_c", [("one_code", 300, 3, 16, 130),
                                            ("zipf", 400, 4, 256, 130),
                                            ("clamped", 200, 2, 16, 33)])
def test_backward_plain_version_on_skewed_codes_is_the_python_loop(kind, B, m, c, d_c):
    """Every row one code, Zipf codes and clamped codes, ragged d_c: the
    plain version of the codebook gradient equals a Python loop adding the
    rows in ascending b, with and without w0."""
    from repro_torch.kernels.hash_decode.ref import hash_decode_backward_ref
    codes = _codes(kind, B, m, c, seed=B)
    rng = np.random.default_rng(B + 1)
    g = (rng.standard_normal((B, d_c)) * np.exp(3 * rng.standard_normal((B, 1)))).astype(np.float32)
    w0 = rng.standard_normal(d_c).astype(np.float32)
    for w in (None, w0):
        gw = g * w[None, :] if w is not None else g
        loop = np.zeros((m, c, d_c), np.float32)
        for b in range(B):
            for j in range(m):
                loop[j, min(max(codes[b, j], 0), c - 1)] += gw[b]
        got = hash_decode_backward_ref(torch.from_numpy(codes), torch.from_numpy(g),
                                       None if w is None else torch.from_numpy(w), c,
                                       torch.float32)
        np.testing.assert_array_equal(got.numpy(), loop)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_empty_and_negative_zero_segments_give_positive_zero(dtype):
    """A code no row has, and a code whose rows' terms are all -0 (g = -0,
    or g = +0 times a negative w0), give +0, not -0: the sum starts from +0."""
    B, m, c, d_c = 6, 2, 8, 4
    codes = torch.tensor([[1, 2]] * 3 + [[3, 2]] * 3, dtype=torch.int32)
    g = torch.full((B, d_c), -0.0)
    g[3:] = 0.0
    w0 = torch.tensor([-1.0, -2.0, 3.0, -0.5])
    for w in (None, w0):
        d_cb = t_ops.codebook_grad(codes, g, w, c, dtype)
        assert d_cb.dtype == dtype
        assert torch.equal(d_cb.float(), torch.zeros(m, c, d_c))
        assert not torch.signbit(d_cb.float()).any()


def test_backward_scratch_and_shared_memory():
    """The scratch sizes come from the library (held on
    the card: ``test_torch_gpu.py::test_backward_sizes_from_the_library``);
    codes beyond the sort's int32 indices, and a device that is neither
    cuda nor cpu, are refused before the library is loaded or anything
    launched."""
    with pytest.raises(ValueError, match="int32"):
        t_ops.sort_sizes(2 ** 20, 2 ** 11, 16)
    with pytest.raises(ValueError, match="cuda"):
        t_ops.code_order(torch.zeros(4, 2, dtype=torch.int32, device="meta"), 16)

"""Port parity: the LSH encode kernel's plain version and Algorithm 1 over
dense auxiliary matrices (``repro_torch.kernels.lsh_encode``,
``repro_torch.core.lsh``) against ``repro.kernels.lsh_encode`` and
``repro.core.lsh``.

The reference runs its Pallas kernel in interpret mode, as the JAX
package's own tests do.  JAX's threefry draws cannot be reproduced in
torch, so the projections are drawn the JAX way and handed to the port.

Tolerances.  With integer-valued A and V (values in [-3, 3] or rounded
Gaussians) every product and partial sum is an integer below 2**24, so any
summation order gives the same f32 sums and the words must match bitwise.
With Gaussian inputs the two packages sum in other orders: a bit may
differ only where the entry is within rounding of its threshold.  Each of
two recursive f32 sums of d products lies within d * 2**-24 * S of the
exact sum (S = sum_k |A_rk V_kj|), so a bit that differs between two
results compared with one threshold t lies where |U - t| <= 2 d 2**-24 S
(U the exact sum, in float64; the bound keeps a factor 2 of margin).
Where each side also takes its own median as t, the bound adds the two
thresholds' difference and one more rounding (3 d 2**-24 S + |t - t'|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codes as jcodes
from repro.core import lsh as jlsh
from repro.kernels.lsh_encode import lsh_encode_packed as j_packed
from repro.kernels.lsh_encode import lsh_encode_word_ref as j_word_ref
from repro.kernels.lsh_encode.kernel import lsh_encode_word as j_word_kernel
from repro_torch.core import codes as tcodes
from repro_torch.core import lsh as tlsh
from repro_torch.kernels.lsh_encode import ops
from repro_torch.kernels.lsh_encode.ref import lsh_encode_word_ref, median0, pack_word

SWEEP = [(2048, 512, 32), (1024, 256, 16), (512, 128, 32)]     # tests/test_kernels.py


def _bits(words: np.ndarray, w: int) -> np.ndarray:
    """(n,) or (n, k) uint32-valued words -> (n, k*w) bits, LSB first."""
    words = np.asarray(words, np.uint64).reshape(words.shape[0], -1)
    shifts = np.arange(w, dtype=np.uint64)
    return ((words[:, :, None] >> shifts) & 1).reshape(words.shape[0], -1).astype(bool)


def _flip_slack(A, V):
    """(exact U in float64, d * 2**-24 * S) for A (n, d), V (d, w)."""
    A64, V64 = np.asarray(A, np.float64), np.asarray(V, np.float64)
    return A64 @ V64, A.shape[1] * 2.0 ** -24 * (np.abs(A64) @ np.abs(V64))


def _inputs(n, d, w, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "integer":
        A = rng.integers(-3, 4, (n, d)).astype(np.float32)
        V = rng.integers(-3, 4, (d, w)).astype(np.float32)
    else:
        A = rng.standard_normal((n, d)).astype(np.float32)
        V = rng.standard_normal((d, w)).astype(np.float32)
    t = np.array(jnp.median(jnp.asarray(A) @ jnp.asarray(V), axis=0))
    return A, V, t


@pytest.mark.parametrize("kind", ["integer", "gaussian"])
@pytest.mark.parametrize("n,d,w", SWEEP)
def test_word_ref_matches_jax_ref_and_pallas_interpret(n, d, w, kind):
    A, V, t = _inputs(n, d, w, kind, seed=n + d + w)
    got = lsh_encode_word_ref(*(torch.from_numpy(x) for x in (A, V, t))).numpy()
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < 2 ** w
    jA, jV, jt = (jnp.asarray(x) for x in (A, V, t))
    refs = {"ref": np.asarray(j_word_ref(jA, jV, jt)),
            "pallas": np.asarray(j_word_kernel(jA, jV, jt, block_n=256, block_d=128,
                                               interpret=True)[:, 0])}
    U, slack = _flip_slack(A, V)
    for name, ref in refs.items():
        if kind == "integer":
            np.testing.assert_array_equal(got, ref.astype(np.int64), err_msg=name)
        else:
            differ = _bits(got, w) != _bits(ref, w)
            assert (np.abs(U - t[None, :])[differ] <= 2 * slack[differ]).all(), name
            assert differ.mean() <= 1e-3, (name, differ.sum())


def _jax_projections(key, d, c, m):
    """The (d, w) Gaussian blocks ``lsh_encode_packed`` and
    ``core.lsh.encode_lsh`` draw from ``key``."""
    nb, out = jcodes.n_bits(c, m), []
    for w in range(jcodes.n_words(c, m)):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.normal(sub, (d, min(32, nb - 32 * w)), jnp.float32)))
    return out


def test_packed_matches_jax_packed_and_core_encode():
    """tests/test_kernels.py's ``lsh_encode_packed`` = ``encode_lsh`` check,
    with the port's wrapper (on the CPU: the plain version) as a third
    side and JAX's projections injected."""
    A = np.array(jax.random.normal(jax.random.PRNGKey(2), (1024, 256)))
    key, c, m = jax.random.PRNGKey(7), 16, 16
    a = np.asarray(j_packed(key, jnp.asarray(A), c, m, block_n=256, block_d=128,
                            interpret=True))
    b = np.asarray(jlsh.encode_lsh(key, jnp.asarray(A), c, m))
    np.testing.assert_array_equal(a, b)
    Vs = _jax_projections(key, 256, c, m)
    tA = torch.from_numpy(A)
    got = ops.lsh_encode_packed(tA, c, m, projections=[torch.from_numpy(V) for V in Vs])
    assert got.dtype == torch.int64 and tuple(got.shape) == a.shape
    # the core door gives the same words as the kernel's own door
    assert torch.equal(got, tlsh.encode_lsh(tA, c, m, projections=[torch.from_numpy(V)
                                                                   for V in Vs]))
    for word, V in enumerate(Vs):
        U, slack = _flip_slack(A, V)
        t_jax = np.median(np.asarray(jnp.asarray(A) @ jnp.asarray(V)), axis=0)
        t_port = median0(tA @ torch.from_numpy(V)).numpy()
        differ = _bits(got[:, word].numpy(), 32) != _bits(a[:, word], 32)
        bound = 3 * slack + np.abs(t_port - t_jax)[None, :]
        assert (np.abs(U - t_jax[None, :])[differ] <= bound[differ]).all(), word
        assert differ.mean() <= 1e-3, (word, differ.sum())


@pytest.mark.parametrize("threshold", ["median", "zero"])
def test_ragged_shape_and_a_16_bit_last_word_bitwise(threshold):
    """n=1000, d=300 (GloVe's width, not a multiple of the kernel's 32-wide
    d-chunks), c=16, m=20: 80 bits, so the last word holds 16.  Integer-valued inputs:
    bitwise against JAX's wrapper (Pallas interpret) and core encode."""
    rng = np.random.default_rng(5)
    A = rng.integers(-3, 4, (1000, 300)).astype(np.float32)
    key, c, m = jax.random.PRNGKey(3), 16, 20
    Vs = [np.round(2 * V).astype(np.float32) for V in _jax_projections(key, 300, c, m)]
    assert [V.shape[1] for V in Vs] == [32, 32, 16]
    ref = []
    for V in Vs:
        U = jnp.asarray(A) @ jnp.asarray(V)
        t = (jnp.median(U, axis=0) if threshold == "median"
             else jnp.zeros((V.shape[1],), jnp.float32))
        ref.append(np.asarray(j_word_kernel(jnp.asarray(A), jnp.asarray(V), t,
                                            block_n=1000, block_d=300, interpret=True)[:, 0]))
        np.testing.assert_array_equal(ref[-1], np.asarray(jlsh._binarize_word(U, threshold)))
    got = ops.lsh_encode_packed(torch.from_numpy(A), c, m, threshold=threshold,
                                projections=[torch.from_numpy(V) for V in Vs])
    np.testing.assert_array_equal(tcodes.to_uint32(got), np.stack(ref, axis=1))
    np.testing.assert_array_equal(
        tcodes.to_uint32(tlsh.encode_lsh(torch.from_numpy(A), c, m, threshold=threshold,
                                         projections=[torch.from_numpy(V) for V in Vs])),
        np.stack(ref, axis=1))


def test_median_sample_draws_distinct_rows_after_each_projection():
    """``median_sample`` takes each word's median over rows drawn without
    replacement from the generator right after that word's projections."""
    rng = np.random.default_rng(6)
    A = torch.from_numpy(rng.integers(-3, 4, (700, 40)).astype(np.float32))
    c, m, k = 256, 8, 97
    got = ops.lsh_encode_packed(A, c, m, generator=torch.Generator().manual_seed(4),
                                median_sample=k)
    g = torch.Generator().manual_seed(4)
    words = []
    for w in range(tcodes.n_words(c, m)):
        V = torch.randn(40, 32, generator=g)
        rows = torch.randperm(700, generator=g)[:k]
        assert rows.unique().numel() == k
        t = median0(A[rows] @ V)
        assert not torch.equal(t, median0(A @ V))
        words.append(lsh_encode_word_ref(A, V, t))
    assert torch.equal(got, torch.stack(words, dim=1))
    # without a sample: the same words as core.lsh from the same generator state
    full = ops.lsh_encode_packed(A, c, m, generator=torch.Generator().manual_seed(4))
    assert torch.equal(full, tlsh.encode_lsh(A, c, m, generator=torch.Generator().manual_seed(4)))
    with pytest.raises(ValueError, match="median_sample"):
        ops.lsh_encode_packed(A, c, m, projections=[torch.zeros(40, 32)] * 2,
                              median_sample=k)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_word_with_16_bit_operands_bitwise_pallas_interpret(dtype):
    """A (and V) stored in 16 bits: widened to f32 as the JAX kernel's body
    widens them; at integer inputs every sum is exact, so bitwise."""
    A, V, t = _inputs(512, 128, 32, "integer", seed=11)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(j_word_kernel(jnp.asarray(A, jdt), jnp.asarray(V), jnp.asarray(t),
                                   block_n=256, block_d=128, interpret=True)[:, 0])
    got = ops.lsh_encode_word(torch.from_numpy(A).to(tdt), torch.from_numpy(V),
                              torch.from_numpy(t))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    both = ops.lsh_encode_word(torch.from_numpy(A).to(tdt), torch.from_numpy(V).to(tdt),
                               torch.from_numpy(t))
    np.testing.assert_array_equal(both.numpy(), ref.astype(np.int64))


def test_wrapper_rejects_bad_operands_and_cuda_without_a_card():
    A, V, t = torch.zeros(10, 6), torch.zeros(6, 5), torch.zeros(5)
    assert torch.equal(ops.lsh_encode_word(A, V, t), torch.zeros(10, dtype=torch.int64))
    with pytest.raises(TypeError):
        ops.lsh_encode_word(A.double(), V, t)
    with pytest.raises(ValueError):
        ops.lsh_encode_word(A, torch.zeros(7, 5), t)           # d mismatch
    with pytest.raises(ValueError):
        ops.lsh_encode_word(torch.zeros(10, 6), torch.zeros(6, 33), torch.zeros(33))
    with pytest.raises(ValueError):
        ops.lsh_encode_word(A, V, torch.zeros(4))
    # a strided A computes as the contiguous one (the plain version reads it
    # as it is; on the card the wrapper copies it)
    At = torch.arange(60, dtype=torch.float32).reshape(6, 10).t() - 30
    assert not At.is_contiguous()
    assert torch.equal(ops.lsh_encode_word(At, V + 1, t), ops.lsh_encode_word(At.contiguous(),
                                                                              V + 1, t))
    with pytest.raises(ValueError):
        ops.lsh_encode_word(A.to("meta"), V.to("meta"), t.to("meta"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tlsh.encode_lsh(A, 16, 8, generator=torch.Generator(device="cuda"))


def _per_word_route(A, c, m, generator, median_sample=None, threshold="median"):
    """Algorithm 1 a word at a time, as the port ran it before every word
    was drawn up front: per word ``randn(d, w)``, that word's ``randperm``
    when sampling, its thresholds from the plain product, its bits."""
    n, d = A.shape
    words = []
    for w in range(tcodes.n_words(c, m)):
        wbits = min(32, tcodes.n_bits(c, m) - 32 * w)
        V = torch.randn(d, wbits, generator=generator)
        rows = (torch.randperm(n, generator=generator)[:median_sample]
                if median_sample is not None else None)
        if threshold == "zero":
            t = torch.zeros(wbits)
        else:
            t = median0((A if rows is None else A[rows]) @ V)
        words.append(lsh_encode_word_ref(A, V, t))
    return torch.stack(words, dim=1)


@pytest.mark.parametrize("median_sample,threshold,c,m", [
    (None, "median", 256, 16), (301, "median", 256, 16), (None, "zero", 16, 20),
    (None, "median", 256, 20)], ids=["median", "sampled-median", "zero-80-bits",
                                     "median-160-bits"])
def test_all_words_at_once_match_the_per_word_route(median_sample, threshold, c, m):
    """Every word's projections drawn up front and encoded in one pass give
    the same words as the per-word route from one generator state, Gaussian
    A included (the plain product's columns do not depend on how many
    columns it has); 160 bits take two passes of up to 128 columns."""
    A = torch.from_numpy(np.random.default_rng(8).standard_normal((1500, 70))
                         .astype(np.float32))
    got = ops.lsh_encode_packed(A, c, m, generator=torch.Generator().manual_seed(11),
                                threshold=threshold, median_sample=median_sample)
    ref = _per_word_route(A, c, m, torch.Generator().manual_seed(11), median_sample,
                          threshold)
    assert got.dtype == torch.int64 and torch.equal(got, ref)
    if median_sample is None:
        assert torch.equal(got, tlsh.encode_lsh(A, c, m, threshold=threshold,
                                                generator=torch.Generator().manual_seed(11)))


@pytest.mark.parametrize("w", [9, 32, 80, 128])
def test_plain_pack_equals_pack_word_by_word(w):
    """``pack`` (on the CPU: the plain version) and ``lsh_encode_words`` of an
    (n, W) projection are ``pack_word`` of each 32-column slice."""
    rng = np.random.default_rng(w)
    A = torch.from_numpy(rng.standard_normal((257, 19)).astype(np.float32))
    V = torch.from_numpy(rng.standard_normal((19, w)).astype(np.float32))
    U = ops.project(A, V)
    t = median0(U)
    words = ops.pack(U, t)
    assert tuple(words.shape) == (257, -(-w // 32)) and words.dtype == torch.int64
    for k in range(words.shape[1]):
        assert torch.equal(words[:, k], pack_word(U[:, 32 * k:32 * k + 32], t[32 * k:32 * k + 32]))
    assert torch.equal(ops.lsh_encode_words(A, V, t), words)
    assert int(words.min()) >= 0 and int(words.max()) < 2 ** 32
    if w <= 32:
        assert torch.equal(ops.lsh_encode_word(A, V, t), words[:, 0])


def test_wide_entries_reject_bad_operands():
    A, V, t = torch.zeros(10, 6), torch.zeros(6, 129), torch.zeros(129)
    with pytest.raises(ValueError, match="1..128"):
        ops.project(A, V)
    with pytest.raises(ValueError, match="1..128"):
        ops.lsh_encode_words(A, V, t)
    with pytest.raises(ValueError):
        ops.pack(torch.zeros(10, 129), t)
    with pytest.raises(ValueError):
        ops.pack(torch.zeros(10, 8), torch.zeros(7))
    with pytest.raises(TypeError):
        ops.pack(torch.zeros(10, 8, dtype=torch.float64), torch.zeros(8))
    with pytest.raises(ValueError):
        ops.encode_dense(A, torch.zeros(6, 32), "mean")
    before = dict(ops.launches_by_kernel)
    ops.encode_dense(A, torch.zeros(6, 32))                       # CPU: plain, no launch
    assert ops.launches_by_kernel == before

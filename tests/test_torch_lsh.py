"""Port parity: Algorithm 1 (``repro_torch.core.lsh``) against
``repro.core.lsh``.

JAX's threefry draws cannot be reproduced in torch, so the projections are
drawn the JAX way and handed to the port.  With integer-valued projections
every product and sum is exact in f32, whatever the summation order, so the
codes must match bitwise.  With the Gaussian draws themselves the sums may
round differently near a threshold; at least 99.9% of the bits must agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codes as jcodes
from repro.core import lsh as jlsh
from repro.graph.generate import powerlaw_graph as j_powerlaw
from repro_torch.core import codes as tcodes
from repro_torch.core import lsh as tlsh
from repro_torch.graph.generate import powerlaw_graph as t_powerlaw

N = 600


@pytest.fixture(scope="module")
def graphs():
    return j_powerlaw(0, N, avg_degree=6, n_classes=4)[0], t_powerlaw(0, N, avg_degree=6, n_classes=4)[0]


def _jax_projections(key, d, c, m):
    """The (d, w) Gaussian blocks ``repro.core.lsh.encode_lsh`` draws."""
    nb, out = jcodes.n_bits(c, m), []
    for w in range(jcodes.n_words(c, m)):
        key, sub = jax.random.split(key)
        wbits = min(32, nb - 32 * w)
        out.append(np.array(jax.random.normal(sub, (d, wbits), jnp.float32)))
    return out


def _jax_encode_with(A, Vs, threshold, hops):
    """JAX Algorithm 1 on given projections (its own projection/binarise
    steps, without the internal draw)."""
    words = []
    for V in Vs:
        U = jnp.asarray(V)
        for _ in range(hops):
            U = (jlsh._project_csr(A, U) if isinstance(A, jlsh.CSRMatrix)
                 else jlsh._project_dense_block(jnp.asarray(A), U, 64))
        words.append(jlsh._binarize_word(U, threshold))
    return np.asarray(jnp.stack(words, axis=1))


@pytest.mark.parametrize("threshold,hops", [("median", 1), ("zero", 1), ("median", 2)])
@pytest.mark.parametrize("c,m", [(16, 8), (4, 20)])
def test_integer_projections_bitwise_csr(graphs, threshold, hops, c, m):
    ja, ta = graphs
    Vs = [np.round(4 * V).astype(np.float32)
          for V in _jax_projections(jax.random.PRNGKey(1), N, c, m)]
    ref = _jax_encode_with(ja, Vs, threshold, hops)
    got = tlsh.encode_lsh(ta, c, m, projections=[torch.from_numpy(V) for V in Vs],
                          threshold=threshold, hops=hops)
    np.testing.assert_array_equal(tcodes.to_uint32(got), ref)


@pytest.mark.parametrize("threshold", ["median", "zero"])
def test_integer_projections_bitwise_dense(threshold):
    rng = np.random.default_rng(4)
    A = rng.integers(-3, 4, (201, 37)).astype(np.float32)       # odd n
    Vs = [np.round(4 * V).astype(np.float32)
          for V in _jax_projections(jax.random.PRNGKey(2), 37, 256, 8)]
    ref = _jax_encode_with(A, Vs, threshold, 1)
    got = tlsh.encode_lsh(torch.from_numpy(A), 256, 8, threshold=threshold,
                          row_block=64, projections=[torch.from_numpy(V) for V in Vs])
    np.testing.assert_array_equal(tcodes.to_uint32(got), ref)


def test_gaussian_projections_agree(graphs):
    ja, ta = graphs
    key, c, m = jax.random.PRNGKey(7), 256, 16
    ref = np.asarray(jlsh.encode_lsh(key, ja, c, m))
    Vs = [torch.from_numpy(V) for V in _jax_projections(key, N, c, m)]
    got = tcodes.to_uint32(tlsh.encode_lsh(ta, c, m, projections=Vs))
    rb = np.unpackbits(ref.view(np.uint8))
    gb = np.unpackbits(got.view(np.uint8))
    agree = (rb == gb).mean()
    assert agree >= 0.999, agree
    np.testing.assert_array_equal(
        tlsh.encode_lsh_codes(ta, c, m, projections=Vs).numpy(),
        tcodes.unpack_codes(tcodes.from_uint32(got), c, m).numpy())


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1001])
def test_median_matches_jnp_median(n):
    U = np.random.default_rng(n).standard_normal((n, 5)).astype(np.float32)
    np.testing.assert_array_equal(tlsh.median0(torch.from_numpy(U)).numpy(),
                                  np.asarray(jnp.median(jnp.asarray(U), axis=0)))


def test_generator_draws_are_seeded_and_random_codes_in_range(graphs):
    _, ta = graphs
    a = tlsh.encode_lsh(ta, 16, 8, generator=torch.Generator().manual_seed(3))
    b = tlsh.encode_lsh(ta, 16, 8, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    r = tcodes.unpack_codes(tlsh.encode_random(torch.Generator().manual_seed(0), 50, 16, 8), 16, 8)
    assert tuple(r.shape) == (50, 8) and int(r.min()) >= 0 and int(r.max()) < 16
    with pytest.raises(ValueError):
        tlsh.encode_lsh(ta, 16, 8)
    with pytest.raises(ValueError, match="square"):
        tlsh.encode_lsh(torch.zeros(5, 3), 16, 8, hops=2,
                        generator=torch.Generator().manual_seed(0))

"""Port parity: ``repro_torch.core.codes`` against ``repro.core.codes``.

Codes are integer bit manipulation, so every comparison is bitwise.  The
same numpy inputs go through both packages; packed words come back from
the port as int64 bit patterns and are compared as uint32.
"""

import numpy as np
import pytest
import torch

from repro.core import codes as jcodes
from repro_torch.core import codes as tcodes

SHAPES = [(256, 16), (2, 128), (4, 3), (16, 5), (8, 7), (2, 31)]


def _codes(n, c, m, seed=0):
    return np.random.default_rng(seed).integers(0, c, (n, m)).astype(np.int32)


@pytest.mark.parametrize("c,m", SHAPES)
def test_pack_unpack_codes_bitwise(c, m):
    codes = _codes(97, c, m)
    ref = np.asarray(jcodes.pack_codes(codes, c, m))
    got = tcodes.pack_codes(torch.from_numpy(codes), c, m)
    assert tcodes.n_words(c, m) == jcodes.n_words(c, m) == ref.shape[1]
    np.testing.assert_array_equal(tcodes.to_uint32(got), ref)
    back = tcodes.unpack_codes(tcodes.from_uint32(ref), c, m)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), np.asarray(jcodes.unpack_codes(ref, c, m)))
    np.testing.assert_array_equal(back.numpy(), codes)


@pytest.mark.parametrize("nb", [1, 31, 32, 33, 100, 128])
def test_pack_bits_bitwise(nb):
    bits = np.random.default_rng(nb).random((13, nb)) < 0.5
    ref = np.asarray(jcodes.pack_bits(bits))
    got = tcodes.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(tcodes.to_uint32(got), ref)
    np.testing.assert_array_equal(
        tcodes.unpack_bits(got, nb).numpy(), np.asarray(jcodes.unpack_bits(ref, nb)))


def test_unpack_codes_keeps_leading_dims():
    c, m = 16, 6
    packed = np.asarray(jcodes.pack_codes(_codes(24, c, m), c, m)).reshape(4, 6, -1)
    got = tcodes.unpack_codes(tcodes.from_uint32(packed), c, m)
    assert tuple(got.shape) == (4, 6, m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcodes.unpack_codes(packed, c, m)))


@pytest.mark.parametrize("c,m,seed", [(256, 16, 0), (2, 128, 3), (64, 9, 7)])
def test_position_codes_bitwise(c, m, seed):
    # ids up to 2**31 - 1 exercise the full 32-bit multiply wrap-around
    ids = np.concatenate([np.arange(50), np.array([2**31 - 1, 123456789, 4000000])])
    ref = np.asarray(jcodes.position_codes(ids.astype(np.int32), c, m, seed=seed))
    got = tcodes.position_codes(torch.from_numpy(ids), c, m, seed=seed)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_count_collisions_and_validation():
    codes = np.array([[1, 2], [1, 2], [0, 3]], np.int32)
    assert tcodes.count_collisions(torch.from_numpy(codes)) == \
        jcodes.count_collisions(codes) == 1
    assert tcodes.code_capacity(4, 3) == jcodes.code_capacity(4, 3)
    with pytest.raises(ValueError):
        tcodes.bits_per_code(6)
    with pytest.raises(ValueError):
        tcodes.n_bits(4, 0)

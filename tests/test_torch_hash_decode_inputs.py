"""Port parity for the hash_decode inputs the port took last: float16
codebooks and strided operands.

Reference run: the JAX package's ``hash_decode(..., interpret=True)`` (the
Pallas kernel in interpret mode, which widens the codebooks in its body)
and ``jax.grad`` through it (its one-hot backward, cast to the codebooks'
dtype), on inputs from numpy seeds.  Tolerances: the forward is the
gather-sum in codebook order on both sides, so bitwise.  The float16
codebook gradient is one f16 rounding of f32 sums taken in another order
(ascending rows here, XLA's one-hot contraction there): within 8e-3 of the
largest gradient, the bound the port holds its bf16 codebook gradient to
(``chip_smoke.py``'s backward check; measured: the same bits); d_w0, f32
sums over the rows in another order, within 1e-5 of the largest (measured:
6.3e-7 of it).  The
card's kernels at f16: ``tests/test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hash_decode import ops as j_ops
from repro_torch.kernels.hash_decode import ops as t_ops

SHAPES = [(256, 16, 256, 512), (512, 4, 64, 256)]


def _inputs(B, m, c, d_c, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, c, (B, m)).astype(np.int32),
            rng.standard_normal((m, c, d_c)).astype(np.float16),
            rng.standard_normal(d_c).astype(np.float32),
            rng.standard_normal((B, d_c)).astype(np.float32))


def _jax_decode(codes, cb, w0):
    return np.asarray(j_ops.hash_decode(jnp.asarray(codes), jnp.asarray(cb),
                                        None if w0 is None else jnp.asarray(w0),
                                        interpret=True))


@pytest.mark.parametrize("with_w0", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_float16_forward_bitwise_pallas_interpret(shape, with_w0):
    codes, cb, w0, _ = _inputs(*shape, seed=shape[0])
    w0 = w0 if with_w0 else None
    got = t_ops.hash_decode(torch.from_numpy(codes), torch.from_numpy(cb),
                            None if w0 is None else torch.from_numpy(w0))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _jax_decode(codes, cb, w0))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_float16_gradients_match_jax_grad(shape):
    codes, cb, w0, r = _inputs(*shape, seed=shape[0] + 1)
    jcb, jw0 = jax.grad(
        lambda c_, w_: (j_ops.hash_decode(jnp.asarray(codes), c_, w_, interpret=True)
                        * jnp.asarray(r)).sum(), argnums=(0, 1))(jnp.asarray(cb), jnp.asarray(w0))
    tcb = torch.from_numpy(cb).requires_grad_(True)
    tw0 = torch.from_numpy(w0).requires_grad_(True)
    (t_ops.hash_decode(torch.from_numpy(codes), tcb, tw0) * torch.from_numpy(r)).sum().backward()
    assert tcb.grad.dtype == torch.float16 and str(jcb.dtype) == "float16"
    ref = np.asarray(jcb, np.float32)
    bound = 8e-3 * np.abs(ref).max()
    assert np.abs(tcb.grad.float().numpy() - ref).max() <= bound
    jw0 = np.asarray(jw0)
    assert np.abs(tw0.grad.numpy() - jw0).max() <= 1e-5 * np.abs(jw0).max()


def test_strided_codes_and_codebooks_are_the_contiguous_call():
    codes, cb, w0, _ = _inputs(256, 8, 16, 256, seed=3)
    tcodes = torch.from_numpy(np.ascontiguousarray(codes.T)).t()       # a transposed view
    wide = torch.zeros(8, 16, 512, dtype=torch.float16)
    tcb = wide[..., ::2]
    tcb.copy_(torch.from_numpy(cb))
    assert not tcodes.is_contiguous() and not tcb.is_contiguous()
    got = t_ops.hash_decode(tcodes, tcb, torch.from_numpy(w0))
    np.testing.assert_array_equal(got.numpy(), _jax_decode(codes, cb, w0))

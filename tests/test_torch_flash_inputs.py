"""Port parity for the flash-attention inputs the port took last: float16,
head dims outside the tiles' widths (4, 100, 136, 256, 320), strided views
and bf16 operands 2 bytes off a 16-byte boundary.

Reference run: the Pallas kernel ``flash_attention_bhsd`` in interpret mode
(f32 inside, the output cast to q's dtype), on inputs from numpy seeds; the
port runs its plain version on the CPU (``mha_ref``: the scores in q's
dtype widened to f32, the softmax in f32, its weights cast back to q's
dtype before ``w @ v``).  Tolerances (``assert_allclose``'s rtol = atol):
2e-5 in float32 and 2e-2 in bfloat16, as ``tests/test_kernels.py``;
5e-3 in float16, whose differences are the f16 rounding of the output
(2**-11 relative) and of the plain version's weights and scores (the
largest measured here is 1.95e-3).  Strided and unaligned operands are
held bitwise to the contiguous, aligned call.  The card's kernels at the
same inputs: ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_bhsd
from repro_torch.kernels.flash_attention import ops as t_ops

DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2),
          "float16": (torch.float16, jnp.float16, 5e-3)}


def _qkv(B, H, K, S, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, K, S, D)).astype(np.float32),
            rng.standard_normal((B, K, S, D)).astype(np.float32))


def _bshd(a, dtype):
    """(B, heads, S, D) numpy -> the port's (B, S, heads, D) tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(a, 1, 2))).to(dtype)


def _against_pallas(B, H, K, S, D, causal, dtype, seed):
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v = _qkv(B, H, K, S, D, seed)
    ref = flash_attention_bhsd(*(jnp.asarray(a, jdt) for a in (q, k, v)), causal=causal,
                               block_q=128, block_k=128, interpret=True)
    got = t_ops.flash_attention(*(_bshd(a, tdt) for a in (q, k, v)), causal=causal)
    assert got.dtype == tdt and tuple(got.shape) == (B, S, H, D)
    want = np.swapaxes(np.asarray(jnp.asarray(ref, jnp.float32)), 1, 2)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 112])
def test_float16_matches_pallas_interpret(D, causal):
    """float16, GQA (4 query heads on 2 KV heads), causal and full."""
    _against_pallas(1, 4, 2, 256, D, causal, "float16", seed=D)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [4, 100, 136, 256, 320])
def test_any_head_dim_matches_pallas_interpret(D, dtype):
    """Head dims the card pads to its tiles (4, 100) or takes at the tile
    of 256 (136, 256) or in panels (320): the plain version on the CPU
    against the Pallas kernel, and the card's route for each."""
    _against_pallas(1, 4, 2, 128, D, True, dtype, seed=D + 1)
    kernel, width = t_ops.kernel_of(DTYPES[dtype][0], D)
    if D > 256:
        assert (kernel, width) == ("panels", D)
    else:
        assert kernel == t_ops.KERNELS[DTYPES[dtype][0]] and width >= -(-D // 8) * 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_strided_views_are_the_contiguous_call(dtype):
    """q every other column of a wider tensor, k and v transposed views:
    the same bits as the contiguous call."""
    tdt = DTYPES[dtype][0]
    q, k, v = (_bshd(a, tdt) for a in _qkv(2, 4, 2, 96, 64, seed=7))
    wide = torch.zeros(q.shape[:-1] + (128,), dtype=tdt)
    qs = wide[..., ::2]
    qs.copy_(q)
    ks = k.transpose(1, 2).contiguous().transpose(1, 2)
    vs = v.transpose(0, 2).contiguous().transpose(0, 2)
    assert not any(t.is_contiguous() for t in (qs, ks, vs))
    assert torch.equal(t_ops.flash_attention(qs, ks, vs), t_ops.flash_attention(q, k, v))


def _shifted(t):
    """A contiguous copy of ``t`` starting one element (2 bytes in bf16)
    past an aligned address."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("causal", [True, False])
def test_unaligned_bf16_operands_are_the_aligned_call(causal):
    q, k, v = (_bshd(a, torch.bfloat16) for a in _qkv(1, 4, 2, 64, 64, seed=8))
    want = t_ops.flash_attention(q, k, v, causal=causal)
    shifted = [_shifted(t) for t in (q, k, v)]
    assert all(t.data_ptr() % 16 == 2 for t in shifted)
    assert torch.equal(t_ops.flash_attention(*shifted, causal=causal), want)

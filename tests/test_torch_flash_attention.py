"""Port parity: the flash-attention kernel's plain version and wrapper
(``repro_torch.kernels.flash_attention``) against the JAX package.

Reference runs: the Pallas kernel ``flash_attention_bhsd`` in interpret
mode on ``tests/test_kernels.py``'s shapes, and ``jax.grad`` through the
JAX wrapper ``flash_attention`` (interpret mode; its backward recomputes
``mha_ref`` in XLA).  Inputs come from numpy seeds.  Tolerances are
``test_kernels.py``'s: 2e-5 in float32 and 2e-2 in bfloat16 (the plain
version takes the scores and ``w @ v`` in bf16 as ``mha_ref`` does, the
kernel in f32), 1e-3 for the gradients.  The CUDA kernel itself runs only
on a card: ``tests/test_torch_gpu.py`` holds it against the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_bhsd
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import mha_ref as j_mha_ref
from repro_torch.kernels.flash_attention import ops as t_ops
from repro_torch.kernels.flash_attention.ref import attention_ref, mha_ref

SHAPES = [(2, 4, 2, 256, 64, True), (1, 8, 8, 128, 64, False),
          (2, 4, 1, 256, 128, True), (1, 2, 2, 512, 64, True)]
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _qkv(B, H, K, Sq, D, seed=0, Skv=None):
    rng = np.random.default_rng(seed)
    Skv = Sq if Skv is None else Skv
    return (rng.standard_normal((B, H, Sq, D)).astype(np.float32),
            rng.standard_normal((B, K, Skv, D)).astype(np.float32),
            rng.standard_normal((B, K, Skv, D)).astype(np.float32))


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,K,S,D,causal", SHAPES)
def test_plain_version_matches_pallas_interpret(B, H, K, S, D, causal, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v = _qkv(B, H, K, S, D)
    ref = flash_attention_bhsd(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                               jnp.asarray(v, jdt), causal=causal,
                               block_q=128, block_k=128, interpret=True)
    got = mha_ref(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal)
    assert got.dtype == tdt and tuple(got.shape) == (B, H, S, D)
    np.testing.assert_allclose(_f32(got), _f32(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,K,S,D,causal", SHAPES[:2])
def test_plain_version_matches_jax_mha_ref(B, H, K, S, D, causal, dtype):
    """Same arithmetic as the JAX oracle, so f32 agrees to matmul rounding."""
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v = _qkv(B, H, K, S, D, seed=1)
    ref = j_mha_ref(*(jnp.asarray(a, jdt) for a in (q, k, v)), causal=causal)
    got = mha_ref(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("Sq,Skv,causal", [(100, 100, True), (77, 77, False),
                                           (64, 130, False)])
def test_wrapper_on_cpu_ragged_lengths(Sq, Skv, causal):
    """Any sequence length: the port handles ragged S itself (the JAX
    wrapper falls back to ``mha_ref`` there, which is the reference)."""
    q, k, v = _qkv(2, 4, 2, Sq, 32, seed=2, Skv=Skv)
    sw = lambda a: np.ascontiguousarray(np.swapaxes(a, 1, 2))
    before = t_ops.flash_attention.launches
    got = t_ops.flash_attention(*(torch.from_numpy(sw(a)) for a in (q, k, v)),
                                causal=causal)
    assert t_ops.flash_attention.launches == before    # CPU: plain version
    ref = j_mha_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), sw(np.asarray(ref)), rtol=2e-5, atol=2e-5)


def test_wrapper_grads_match_jax_grad():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 128, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, 128, 2, 64)).astype(np.float32)
    v = rng.standard_normal((2, 128, 2, 64)).astype(np.float32)
    gj = jax.grad(lambda *a: (j_flash(*a, block_q=64, block_k=64,
                                      interpret=True) ** 2).sum(),
                  argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (t_ops.flash_attention(*ts) ** 2).sum().backward()
    for t, g in zip(ts, gj):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-3, atol=1e-3)


def test_wrapper_equals_its_plain_version_in_bshd():
    q, k, v = (torch.from_numpy(np.ascontiguousarray(np.swapaxes(a, 1, 2)))
               for a in _qkv(1, 4, 2, 96, 64, seed=3))
    assert torch.equal(t_ops.flash_attention(q, k, v), attention_ref(q, k, v))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """Float64 and mixed dtypes are refused; float16, any head dim and any
    layout compute (the plain version on the CPU, as JAX's wrapper)."""
    q, k, v = (torch.from_numpy(np.ascontiguousarray(np.swapaxes(a, 1, 2)))
               for a in _qkv(1, 4, 2, 16, 64))
    with pytest.raises(TypeError):
        t_ops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        t_ops.flash_attention(q, k.to(torch.bfloat16), v)
    h = [t.half() for t in (q, k, v)]
    assert torch.equal(t_ops.flash_attention(*h), attention_ref(*h))
    # the head dim: any D; on the card D % 8 != 0 pads to the step and D >
    # 256 runs the panel kernel
    q48, k48, v48 = (t[..., :48].contiguous() for t in (q, k, v))
    assert torch.equal(t_ops.flash_attention(q48, k48, v48), attention_ref(q48, k48, v48))
    assert t_ops.kernel_of(torch.float32, 100) == ("f32_cuda_core", 128)
    assert t_ops.kernel_of(torch.bfloat16, 136) == ("bf16_wgmma", 256)
    assert t_ops.kernel_of(torch.float16, 4) == ("f16_wgmma", 32)
    assert t_ops.kernel_of(torch.bfloat16, 320) == ("panels", 320)
    with pytest.raises(ValueError):
        t_ops.flash_attention(q[:, :, :3].contiguous(), k, v)      # H % K != 0
    got = t_ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                                k.transpose(1, 2).contiguous().transpose(1, 2), v)
    assert torch.equal(got, t_ops.flash_attention(q, k, v))


def _shifted(t):
    """A contiguous copy of ``t`` whose data starts 2 bytes past an aligned address."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def test_wrapper_rejects_unaligned_bf16_operands():
    """An operand 2 bytes off a 16-byte boundary computes as the aligned one
    does: the plain version reads it where it is on the CPU (on the card the
    wrapper copies it to an aligned tensor, counted in ``copies``)."""
    q, k, v = (torch.from_numpy(np.ascontiguousarray(np.swapaxes(a, 1, 2))).to(torch.bfloat16)
               for a in _qkv(1, 4, 2, 16, 64))
    want = t_ops.flash_attention(q, k, v)
    copies = t_ops.flash_attention.copies
    for i in range(3):
        args = [q, k, v]
        args[i] = _shifted(args[i])
        assert args[i].data_ptr() % 16 and args[i].is_contiguous()
        assert torch.equal(t_ops.flash_attention(*args), want)
    assert t_ops.flash_attention.copies == copies       # the CPU copies nothing
    q32 = _shifted(q.float())
    assert torch.equal(t_ops.flash_attention(q32, k.float(), v.float()),
                       attention_ref(q32, k.float(), v.float()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_calls_move_no_launch_count(dtype):
    q, k, v = (torch.from_numpy(np.ascontiguousarray(np.swapaxes(a, 1, 2))).to(dtype)
               for a in _qkv(1, 4, 2, 32, 32))
    by_kernel = dict(t_ops.flash_attention.launches_by_kernel)
    assert set(by_kernel) == {"bf16_wgmma", "f16_wgmma", "f32_cuda_core", "panels"}
    t_ops.flash_attention(q, k, v)
    assert t_ops.flash_attention.launches_by_kernel == by_kernel

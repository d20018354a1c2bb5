"""Port parity for the Mamba2 SSD mixer (``repro_torch.nn.ssm``) and its
cache against the JAX package's ``repro.nn.ssm`` on the CPU, and the JAX
package's own SSD cases (``tests/test_nn.py``) on the port.

Params are JAX's ``init_ssm`` draw carried across with ``params_from_jax``;
inputs come from numpy seeds; TF32 is off; f32 throughout.  Bounds:
``ssd_chunked`` within 2e-5 of JAX's (einsums and a cumulative sum in
another order over up to 32 steps) and both the chunked scan and the
single-step recurrence within 1e-4 of ``ssd_reference`` (``test_nn.py``'s
bound); ``ssm_forward`` and its gradients within 2e-5 of JAX's; decode
against the forward 1e-3 and the halves' continuation 1e-4, ``test_nn.py``'s
bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import kvcache as j_kv
from repro.nn import ssm as j_ssm
from repro_torch.device import disable_tf32
from repro_torch.interop import params_from_jax
from repro_torch.nn import kvcache as t_kv
from repro_torch.nn import ssm as t_ssm

disable_tf32()


def _scan_inputs(B=2, S=32, H=4, P=8, N=16, seed=0):
    """``test_nn.py``'s draw, from numpy: dt after a softplus, A negative."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bc = rng.standard_normal((B, S, N)).astype(np.float32)
    Cc = rng.standard_normal((B, S, N)).astype(np.float32)
    return X, dt, A, Bc, Cc


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_ssd_chunked_matches_jax_and_reference(chunk):
    args = _scan_inputs()
    jy, js = j_ssm.ssd_chunked(*map(jnp.asarray, args), chunk)
    ty, ts = t_ssm.ssd_chunked(*_t(*args), chunk)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2e-5, atol=2e-5)
    ref = t_ssm.ssd_reference(*_t(*args))
    np.testing.assert_allclose(ty.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        ref.numpy(), np.asarray(j_ssm.ssd_reference(*map(jnp.asarray, args))),
        rtol=2e-5, atol=2e-5)


def test_ssd_state_continuation():
    """``test_nn.py``: a prefill in two halves, the state carried, equals
    one pass."""
    X, dt, A, Bc, Cc = _t(*_scan_inputs(B=1, H=2, N=8, seed=1))
    y_full, s_full = t_ssm.ssd_chunked(X, dt, A, Bc, Cc, 8)
    y1, s1 = t_ssm.ssd_chunked(X[:, :16], dt[:, :16], A, Bc[:, :16], Cc[:, :16], 8)
    y2, s2 = t_ssm.ssd_chunked(X[:, 16:], dt[:, 16:], A, Bc[:, 16:], Cc[:, 16:], 8,
                               init_state=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), rtol=1e-4, atol=1e-4)


def test_ssd_gradient_finite_where_jax_overflows():
    """At mamba2's 80 heads (A down to -80) and its dt range, a 128-step
    chunk's cumulative decays differ by hundreds, so exp(dec) above the
    diagonal overflows.  JAX takes that exp before masking and its dt
    gradient is NaN (0 * inf); the port masks first: the same forward
    values, every gradient finite and, below the overflow, JAX's."""
    H, L = 80, 128
    rng = np.random.default_rng(2)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (1, L, H))).astype(np.float32)
    A = -np.arange(1, H + 1, dtype=np.float32)
    X = rng.standard_normal((1, L, H, 4)).astype(np.float32)
    Bc, Cc = (rng.standard_normal((1, L, 8)).astype(np.float32) for _ in range(2))
    jy, _ = j_ssm.ssd_chunked(*map(jnp.asarray, (X, dt, A, Bc, Cc)), L)
    jg = jax.grad(lambda d: (j_ssm.ssd_chunked(jnp.asarray(X), d, jnp.asarray(A),
                                               jnp.asarray(Bc), jnp.asarray(Cc),
                                               L)[0] ** 2).sum())(jnp.asarray(dt))
    assert not np.isfinite(np.asarray(jg)).all()
    tdt = torch.from_numpy(dt).requires_grad_(True)
    ty, _ = t_ssm.ssd_chunked(torch.from_numpy(X), tdt, *_t(A, Bc, Cc), L)
    (ty ** 2).sum().backward()
    assert bool(tdt.grad.isfinite().all())
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=2e-5, atol=2e-5)
    # 16 heads (A >= -16): no overflow, and the two gradients agree
    sl = slice(0, 16)
    jg16 = jax.grad(lambda d: (j_ssm.ssd_chunked(
        jnp.asarray(X[:, :, sl]), d, jnp.asarray(A[sl]), jnp.asarray(Bc), jnp.asarray(Cc),
        L)[0] ** 2).sum())(jnp.asarray(dt[:, :, sl]))
    tdt16 = torch.from_numpy(dt[:, :, sl].copy()).requires_grad_(True)
    (t_ssm.ssd_chunked(torch.from_numpy(X[:, :, sl].copy()), tdt16,
                       *_t(A[sl].copy(), Bc, Cc), L)[0] ** 2).sum().backward()
    np.testing.assert_allclose(tdt16.grad.numpy(), np.asarray(jg16), rtol=1e-4, atol=1e-4)


def _mixer(seed=0, **fields):
    kw = dict(d_model=32, d_state=16, headdim=8, chunk=8, **fields)
    jcfg, tcfg = j_ssm.SSMConfig(**kw), t_ssm.SSMConfig(**kw)
    jp = j_ssm.init_ssm(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jp, device="cpu")


def test_init_ssm_tree_matches_jax():
    jcfg, tcfg, jp, tp = _mixer()
    mine = t_ssm.init_ssm(torch.Generator().manual_seed(0), tcfg)
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    for k in ("D_skip", "norm_scale", "conv_x_b"):
        assert torch.equal(mine[k], tp[k])
    np.testing.assert_allclose(mine["A_log"].numpy(), tp["A_log"].numpy(), rtol=1e-6)
    dt = torch.nn.functional.softplus(mine["dt_bias"])
    assert float(dt.min()) >= 1e-3 - 1e-9 and float(dt.max()) <= 1e-1 + 1e-9


def test_ssm_forward_and_grads_match_jax():
    jcfg, tcfg, jp, tp = _mixer(1)
    x = np.random.default_rng(3).standard_normal((2, 32, 32)).astype(np.float32)
    g = np.random.default_rng(4).standard_normal((2, 32, 32)).astype(np.float32)
    jy, jvjp = jax.vjp(lambda p, xx: j_ssm.ssm_forward(p, xx, jcfg)[0], jp, jnp.asarray(x))
    jgp, jgx = jvjp(jnp.asarray(g))
    tpg = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, cache = t_ssm.ssm_forward(tpg, tx, tcfg)
    assert cache is None
    (ty * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=2e-5, atol=2e-5)
    for k, v in tpg.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jgp[k]), rtol=2e-5, atol=2e-5,
                                   err_msg=k)


def test_ssm_decode_equals_forward_and_jax_decode():
    """``test_nn.py``'s case: 32 single steps against the chunked pass; and
    the port's steps against JAX's, state and conv tail included."""
    jcfg, tcfg, jp, tp = _mixer(2)
    x = np.random.default_rng(5).standard_normal((2, 32, 32)).astype(np.float32)
    y_full, _ = t_ssm.ssm_forward(tp, torch.from_numpy(x), tcfg)
    dims = (2, tcfg.n_heads, tcfg.d_state, tcfg.headdim, tcfg.conv_width, tcfg.conv_channels)
    tcache = t_kv.SSMCache.zeros(*dims, device="cpu")
    jcache = j_kv.SSMCache.zeros(*dims)
    outs = []
    for t in range(32):
        yt, tcache = t_ssm.ssm_forward(tp, torch.from_numpy(x[:, t:t + 1]), tcfg, cache=tcache)
        jyt, jcache = j_ssm.ssm_forward(jp, jnp.asarray(x[:, t:t + 1]), jcfg, cache=jcache)
        np.testing.assert_allclose(yt.numpy(), np.asarray(jyt), rtol=2e-5, atol=2e-5)
        outs.append(yt)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), y_full.numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tcache.state.numpy(), np.asarray(jcache.state),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tcache.conv.numpy(), np.asarray(jcache.conv),
                               rtol=2e-5, atol=2e-5)


def test_ssm_prefill_into_cache_then_decode_continues():
    """A 16-step prefill into a zero cache and 4 single steps from it, against
    a 24-step forward without a cache (causal: its first 20 outputs; 1e-3)."""
    _, tcfg, _, tp = _mixer(3)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 24, 32)).astype(np.float32))
    full, _ = t_ssm.ssm_forward(tp, x, tcfg)
    cache = t_kv.SSMCache.zeros(1, tcfg.n_heads, tcfg.d_state, tcfg.headdim,
                                tcfg.conv_width, tcfg.conv_channels, device="cpu")
    y, cache = t_ssm.ssm_forward(tp, x[:, :16], tcfg, cache=cache)
    assert torch.equal(y, t_ssm.ssm_forward(tp, x[:, :16], tcfg)[0])
    steps = [y]
    for t in range(16, 20):
        yt, cache = t_ssm.ssm_forward(tp, x[:, t:t + 1], tcfg, cache=cache)
        steps.append(yt)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full[:, :20].numpy(),
                               rtol=1e-3, atol=1e-3)

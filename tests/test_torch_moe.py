"""Port parity for the MoE FFN (``repro_torch.nn.moe``) against the JAX
package's ``repro.nn.moe`` on the CPU, and the JAX package's own MoE cases
(``tests/test_nn.py``, ``tests/test_perf_features.py``) on the port.

Params are JAX's ``init_moe`` draw carried across with ``params_from_jax``;
inputs come from numpy seeds; TF32 is off; f32 throughout.  Bounds: router
ids equal and weights within 1e-6 (one f32 softmax and a renormalisation);
``moe_ffn`` and ``moe_dense_ffn`` within 1e-5 of JAX's (f32 products in
another order: ``ragged_dot`` against one matmul a group, and for the
dense form ``"tef,te,efd->td"`` against a weighted hidden times one
(E*F, D) product; measured below 1e-6); their gradients within rtol = atol
= 1e-5 (the largest gap measured, 1.3e-5, on a large entry); the
port's dense form against its sorted one and both against the per-expert
oracle within 2e-4, the JAX tests' bound.  The gradient at 8 CPU threads is
the same bits over two runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import moe as j_moe
from repro_torch.device import disable_tf32
from repro_torch.interop import params_from_jax
from repro_torch.nn import moe as t_moe

disable_tf32()

GRANITE_CUT = dict(d_model=64, d_ff=32, n_experts=10, top_k=4, n_experts_padded=16)


def _case(seed=0, T=96, act="swiglu", **fields):
    kw = dict(GRANITE_CUT, act=act, **fields)
    jcfg, tcfg = j_moe.MoEConfig(**kw), t_moe.MoEConfig(**kw)
    jp = j_moe.init_moe(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed).standard_normal((T, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, params_from_jax(jp, device="cpu"), x


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_ids_equal_and_weights_match_jax(seed):
    jcfg, tcfg, jp, tp, x = _case(seed)
    jw, jidx = j_moe.router_probs(jp, jnp.asarray(x), jcfg)
    tw, tidx = t_moe.router_probs(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tw, jw, 1e-6)
    assert int(tidx.max()) < tcfg.n_experts                     # the pad never routed


def test_topk_ties_go_to_the_first_index_as_in_jax():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                      [0.0, 0.5, 0.0, 0.5]], np.float32)
    jw, jidx = j_moe._topk_argmax(jnp.asarray(probs), 3)
    tw, tidx = t_moe._topk_argmax(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert tidx.tolist()[0] == [0, 1, 2]


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("impl", ["sorted", "dense"])
def test_moe_ffn_and_grads_match_jax(impl, act):
    jcfg, tcfg, jp, tp, x = _case(3, act=act)
    jfn = j_moe.moe_ffn if impl == "sorted" else j_moe.moe_dense_ffn
    tfn = t_moe.moe_ffn if impl == "sorted" else t_moe.moe_dense_ffn
    g = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    jy, jvjp = jax.vjp(lambda p, xx: jfn(p, xx, jcfg), jp, jnp.asarray(x))
    jgp, jgx = jvjp(jnp.asarray(g))
    tpg = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tfn(tpg, tx, tcfg)
    (ty * torch.from_numpy(g)).sum().backward()
    _close(ty, jy, 1e-5)
    _close(tx.grad, jgx, 1e-5)
    for k in ("w_up", "w_down", "router"):
        _close(tpg[k].grad, jgp[k], 1e-5)
    assert float(tpg["w_up"].grad[tcfg.n_experts:].abs().max()) == 0.0   # the pad


def test_moe_matches_dense_oracle():
    """``tests/test_nn.py``'s oracle: each expert on every token, weighted."""
    _, tcfg, _, tp, x = _case(5, T=64)
    tx = torch.from_numpy(x)
    w, idx = t_moe.router_probs(tp, tx, tcfg)
    ref = torch.zeros_like(tx)
    for e in range(tcfg.e_pad):
        h = torch.nn.functional.silu(tx @ tp["w_gate"][e]) * (tx @ tp["w_up"][e])
        ref += (h @ tp["w_down"][e]) * (w * (idx == e)).sum(-1)[:, None]
    _close(t_moe.moe_ffn(tp, tx, tcfg), ref.numpy(), 2e-4)
    _close(t_moe.moe_dense_ffn(tp, tx, tcfg), ref.numpy(), 2e-4)


def test_moe_dense_equals_sorted_and_respects_padding():
    """``tests/test_perf_features.py``'s two cases: the forms agree, and the
    dense one reads only the real experts (the pad's weights poisoned with
    NaN change nothing)."""
    _, tcfg, _, tp, x = _case(6, T=64)
    tx = torch.from_numpy(x)
    dense = t_moe.moe_dense_ffn(tp, tx, tcfg)
    _close(dense, t_moe.moe_ffn(tp, tx, tcfg).numpy(), 2e-4)
    poisoned = dict(tp)
    for k in ("w_gate", "w_up", "w_down"):
        poisoned[k] = tp[k].clone()
        poisoned[k][tcfg.n_experts:] = float("nan")
    assert torch.equal(t_moe.moe_dense_ffn(poisoned, tx, tcfg), dense)
    assert torch.equal(t_moe.moe_ffn(poisoned, tx, tcfg), t_moe.moe_ffn(tp, tx, tcfg))


def test_moe_grads_finite_and_ep_without_mesh_is_sorted():
    _, tcfg, _, tp, x = _case(7, T=32)
    tx = torch.from_numpy(x)
    tpg = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    (t_moe.moe_ffn_ep(tpg, tx, tcfg) ** 2).sum().backward()
    assert all(bool(v.grad.isfinite().all()) for v in tpg.values())
    assert torch.equal(t_moe.moe_ffn_ep(tp, tx, tcfg), t_moe.moe_ffn(tp, tx, tcfg))


def test_moe_ep_across_ranks_raises_naming_its_item():
    from repro_torch.parallel.sharding import DataMesh, use_sharding
    _, tcfg, _, tp, x = _case(8, T=8)
    with use_sharding(DataMesh(rank=0, size=2, device=torch.device("cpu"))):
        with pytest.raises(NotImplementedError, match="A.18"):
            t_moe.moe_ffn_ep(tp, torch.from_numpy(x), tcfg)


@pytest.mark.parametrize("impl", ["sorted", "dense"])
def test_moe_gradient_same_bits_at_8_threads(impl):
    """Two backward passes at 8 CPU threads over 4,096 tokens (each expert
    group hundreds of rows): the same bits (the combine has no
    accumulating scatter)."""
    _, tcfg, _, tp, _ = _case(9)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (4096, tcfg.d_model)).astype(np.float32))
    fn = t_moe.moe_ffn if impl == "sorted" else t_moe.moe_dense_ffn
    prev = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        runs = []
        for _ in range(2):
            tpg = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
            tx = x.clone().requires_grad_(True)
            (fn(tpg, tx, tcfg) ** 2).sum().backward()
            runs.append([tx.grad] + [tpg[k].grad for k in sorted(tpg)])
    finally:
        torch.set_num_threads(prev)
    assert all(torch.equal(a, b) for a, b in zip(*runs))

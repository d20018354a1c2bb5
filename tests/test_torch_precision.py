"""int8 storage in the port against the JAX package (tests/test_precision.py).

The straight-through int8 gradient: a decode from int8 storage sees
``dequantize(quantize(cb))``, and its codebook gradient goes to the float
masters unchanged (JAX ``quantize_dequantize``, identity backward), so it
is bitwise the unquantized codebook gradient of the same backend.  The
kernel path's ``d_w0`` sums the cotangent against what the forward
decoded, the int8 values (JAX ``_bwd_int8``).

Tolerances: the codebook gradient is an f32 sum of the same terms in both
packages, in ascending row order in the port and as XLA's one-hot
contraction in JAX: rtol = atol = 1e-5.  ``d_w0`` sums B * d_c products in
different orders: rtol = 1e-5 on its largest entry.  The int8 forward of
gather and of the kernel's plain version are the same f32 products summed
in codebook order, so they are bitwise each other's and JAX's gather;
onehot is a matmul, within 1e-5 (JAX's own bound between its backends).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jbackend
from repro.kernels.hash_decode import ops as j_hd_ops
from repro_torch.configs.paper_gnn import paper_gnn_config
from repro_torch.core import backend as tbackend
from repro_torch.graph.runtime import GraphRuntime, GraphSource, RuntimeSpec

CPU = torch.device("cpu")
INT8 = tbackend.MixedPrecisionPolicy(quantize="int8")


def _operands(B, m, c, d_c, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, c, (B, m)).astype(np.int32),
            rng.standard_normal((m, c, d_c)).astype(np.float32),
            rng.standard_normal(d_c).astype(np.float32),
            rng.standard_normal((B, d_c)).astype(np.float32))


def _port_grads(name, policy, codes, cb, w0, g):
    """(d_cb, d_w0 or None) of ``sum(decode * g)`` through the port's backend."""
    tcb = torch.from_numpy(cb).requires_grad_(True)
    tw0 = None if w0 is None else torch.from_numpy(w0).requires_grad_(True)
    out = tbackend.get_backend(name, device=CPU, policy=policy).decode(
        torch.from_numpy(codes), tcb, tw0)
    (out * torch.from_numpy(g)).sum().backward()
    return tcb.grad, None if tw0 is None else tw0.grad


def _jax_grads(name, policy, codes, cb, w0, g):
    be = jbackend.get_backend(name, interpret=True, policy=policy)
    args = (jnp.asarray(cb),) + (() if w0 is None else (jnp.asarray(w0),))
    grads = jax.grad(lambda *a: (be.decode(jnp.asarray(codes), *a) * jnp.asarray(g)).sum(),
                     argnums=tuple(range(len(args))))(*args)
    return [np.asarray(x) for x in grads]


def test_int8_gradient_is_straight_through():
    """gather and onehot: the int8 codebook gradient is bitwise the
    unquantized one of the same backend, and within 1e-5 of JAX's int8
    gradient.  Through the plain quantize ops (no gradient through round
    and the int8 cast, only the scales' path left) it differs from the
    unquantized one by 5.47 at these inputs (m=4, c=16, d_c=8, B=32)."""
    codes, cb, _, g = _operands(32, 4, 16, 8)
    jax_int8 = _jax_grads("gather", jbackend.MixedPrecisionPolicy(quantize="int8"),
                          codes, cb, None, g)[0]
    for name in ("gather", "onehot"):
        d_int8, _ = _port_grads(name, INT8, codes, cb, None, g)
        d_f32, _ = _port_grads(name, None, codes, cb, None, g)
        assert torch.equal(d_int8, d_f32), (name, float((d_int8 - d_f32).abs().max()))
        np.testing.assert_allclose(d_int8.numpy(), jax_int8, rtol=1e-5, atol=1e-5)
    # the forward still decodes the int8 values
    out = tbackend.get_backend("gather", device=CPU, policy=INT8).decode(
        torch.from_numpy(codes), torch.from_numpy(cb))
    assert not torch.equal(out, tbackend.get_backend("gather", device=CPU).decode(
        torch.from_numpy(codes), torch.from_numpy(cb)))


@pytest.mark.parametrize("with_w0", [False, True], ids=["full", "light"])
def test_kernel_int8_backward_is_straight_through(with_w0):
    """The kernel path's int8 backward (plain versions on the CPU): ``d_cb``
    bitwise the unquantized kernel path's, in the masters' dtype; ``d_w0``
    (light variant) within 1e-5 of JAX ``_bwd_int8``, which sums against
    the int8 decode: the masters' decode gives a ``d_w0`` off by more."""
    codes, cb, w0, g = _operands(256, 4, 16, 128, seed=1)
    w0 = w0 if with_w0 else None
    d_cb, d_w0 = _port_grads("pallas", INT8, codes, cb, w0, g)
    ref_cb, ref_w0 = _port_grads("pallas", None, codes, cb, w0, g)
    assert d_cb.dtype == torch.float32 and torch.equal(d_cb, ref_cb)
    jg = _jax_grads("pallas", jbackend.MixedPrecisionPolicy(quantize="int8"),
                    codes, cb, w0, g)
    np.testing.assert_allclose(d_cb.numpy(), jg[0], rtol=1e-5, atol=1e-5)
    if with_w0:
        scale = np.abs(jg[1]).max()
        np.testing.assert_allclose(d_w0.numpy(), jg[1], rtol=0, atol=1e-5 * scale)
        assert np.abs(ref_w0.numpy() - jg[1]).max() > 1e-3 * scale
    # bf16 masters take a bf16 gradient, the unquantized one's bits
    bf16 = tbackend.MixedPrecisionPolicy(param_dtype="bfloat16", quantize="int8")
    d_bf, _ = _port_grads("pallas", bf16, codes, cb, w0, g)
    ref_bf, _ = _port_grads("pallas", tbackend.MixedPrecisionPolicy(param_dtype="bfloat16"),
                            codes, cb, w0, g)
    assert torch.equal(d_bf, ref_bf)


def test_int8_decode_parity_across_backends():
    """gather and the kernel's plain version decode the same f32 products
    in the same order: bitwise each other and JAX's gather; onehot within
    1e-5 (mirrors tests/test_precision.py)."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 128, (256, 8)).astype(np.int32)
    cb = rng.standard_normal((8, 128, 128)).astype(np.float32)
    out = {n: tbackend.get_backend(n, device=CPU, policy=INT8).decode(
        torch.from_numpy(codes), torch.from_numpy(cb)).numpy()
        for n in ("gather", "onehot", "pallas")}
    ref = np.asarray(jbackend.GatherBackend(policy=jbackend.MixedPrecisionPolicy(
        quantize="int8")).decode(jnp.asarray(codes), jnp.asarray(cb)))
    np.testing.assert_array_equal(out["gather"], ref)
    np.testing.assert_array_equal(out["pallas"], ref)
    np.testing.assert_allclose(out["onehot"], out["gather"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tbackend.hd_ops.quantize_dequantize(torch.from_numpy(cb)).numpy(),
        np.asarray(j_hd_ops.quantize_dequantize(jnp.asarray(cb))))


# ---------------- end-to-end drift (mirrors tests/test_precision.py) -------

N_NODES, N_CLASSES = 600, 8


@pytest.fixture(scope="module")
def graph():
    return GraphSource(kind="powerlaw", seed=0, n_nodes=N_NODES, n_classes=N_CLASSES).build()


def _step0_loss(graph, lookup_impl, **emb):
    spec = RuntimeSpec(
        graph=GraphSource(kind="powerlaw", seed=0, n_nodes=N_NODES, n_classes=N_CLASSES),
        model=paper_gnn_config("sage", n_nodes=N_NODES, n_classes=N_CLASSES, fanout=3),
        batch_size=32, pad_to=128, log_every=1, data_seed=1, prefetch_depth=0,
    ).with_updates(c=16, m=8, d_c=128, d_m=32, lookup_impl=lookup_impl, **emb)
    losses = GraphRuntime.from_spec(spec, graph=graph, device="cpu").train(1).losses
    assert np.isfinite(losses[0])
    return losses[0]


@pytest.mark.parametrize("impl", ["onehot", "pallas", "hashemb"])
def test_step0_loss_drift_within_bounds(graph, impl):
    base = _step0_loss(graph, impl)
    for variant, bound in ((dict(param_dtype="bfloat16"), "bfloat16"),
                           (dict(quantize="int8"), "int8")):
        drift = abs(_step0_loss(graph, impl, **variant) - base) / abs(base)
        assert drift <= tbackend.DRIFT_BOUNDS[bound], (impl, variant, drift)

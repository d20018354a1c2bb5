"""Port parity: ``flash_attention`` at head dims outside 32, 64 and 128
(zamba2-7b's shared block has heads of 112) against the JAX package on the
CPU.

References: the Pallas kernel ``flash_attention_bhsd`` in interpret mode at
D in {24, 80, 112}, causal and full, with GQA; ``jax.grad`` through the JAX
wrapper ``flash_attention`` (interpret mode) at D = 112; and a small hybrid
LM at ``d_head=112`` (the reduced zamba2 with 2 heads of 112) under the
port's ``attn_impl="flash"`` against JAX's ``attn_impl="xla"`` (JAX's
``attention`` does not pass ``interpret``, so its flash path cannot run
here), from JAX's ``init_lm`` draw carried across by ``params_from_jax``.
Inputs come from numpy seeds; TF32 is off.

Tolerances: ``tests/test_kernels.py``'s 2e-5 in float32 and 2e-2 in
bfloat16 for the attention, 1e-3 for its gradients (as
``test_torch_flash_attention.py``, also for the hybrid's raw gradients);
the hybrid's other bounds are ``test_torch_lm_families.py``'s: logits 5e-5,
loss 1e-5, params 1e-4 after a step from JAX's state; besides, each of the
hybrid's gradient leaves and each leaf's update within 1e-4 of that leaf's
largest entry (``GRAD_REL``, ``DELTA``), bounds that planted controls fail.
The kernels at these D run on the card: ``tests/test_torch_gpu.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.kernels.flash_attention.kernel import flash_attention_bhsd
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.models import lm as j_lm
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.train.step import TrainHyper as JTrainHyper
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs import get_config, reduced
from repro_torch.device import disable_tf32
from repro_torch.interop import params_from_jax
from repro_torch.kernels.flash_attention import ops as t_ops
from repro_torch.models import lm as t_lm
from repro_torch.nn.module import map_tree
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import TrainHyper, make_train_step

disable_tf32()

DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}
# (B, H, K, S, D, causal): GQA with 2 and 4 query heads a KV head, and MHA
CASES = [(1, 4, 2, 128, 24, True), (2, 4, 1, 128, 24, False),
         (1, 4, 2, 128, 80, False), (2, 2, 2, 128, 80, True),
         (1, 4, 2, 128, 112, True), (1, 4, 1, 128, 112, False)]
LOGITS_TOL, LOSS_TOL, PARAMS_TOL, GRAD_TOL = 5e-5, 1e-5, 1e-4, 1e-3
# the hybrid's step: AdamW at lr 1, eps 1 and no warmup (as
# tests/test_torch_lm_ranks.py's HYPER), so that it moves each weight by about
# its clipped gradient; at lr 1e-3 the update sat under PARAMS_TOL, and a
# state left unchanged passed. At eps 1e-8 an entry whose gradient sits near
# eps moves by O(lr) on a rounding-level change (ROADMAP, queue C)
STEP_OPT = dict(lr=1.0, weight_decay=0.01, clip_norm=1.0, eps=1.0)
# each leaf's gradient, and the step's update, against JAX's: max |got -
# want| / max |want| a leaf. Read on the CPU: gradients 4.6e-6, update
# 8.5e-6; the controls read 0.48 (the shared block's gradient from its first
# site alone) and 1.0 (a state left unchanged)
GRAD_REL, DELTA = 1e-4, 1e-4


def _qkv(B, H, K, S, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, K, S, D)).astype(np.float32),
            rng.standard_normal((B, K, S, D)).astype(np.float32))


def _bshd(a):
    return np.ascontiguousarray(np.swapaxes(a, 1, 2))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,K,S,D,causal", CASES)
def test_flash_at_head_dim_matches_pallas_interpret(B, H, K, S, D, causal, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v = _qkv(B, H, K, S, D, seed=D + 7 * H)
    ref = flash_attention_bhsd(*(jnp.asarray(a, jdt) for a in (q, k, v)), causal=causal,
                               block_q=64, block_k=64, interpret=True)
    before = t_ops.flash_attention.launches
    got = t_ops.flash_attention(*(torch.from_numpy(_bshd(a)).to(tdt) for a in (q, k, v)),
                                causal=causal)
    assert t_ops.flash_attention.launches == before          # the CPU runs the plain version
    assert got.dtype == tdt and tuple(got.shape) == (B, S, H, D)
    np.testing.assert_allclose(got.float().numpy(),
                               _bshd(np.asarray(jnp.asarray(ref, jnp.float32))),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_gradients_at_head_dim_112_match_jax_grad(causal):
    rng = np.random.default_rng(112)
    q = rng.standard_normal((2, 128, 4, 112)).astype(np.float32)
    k = rng.standard_normal((2, 128, 2, 112)).astype(np.float32)
    v = rng.standard_normal((2, 128, 2, 112)).astype(np.float32)
    gj = jax.grad(lambda *a: (j_flash(*a, causal=causal, block_q=64, block_k=64,
                                      interpret=True) ** 2).sum(),
                  argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (t_ops.flash_attention(*ts, causal=causal) ** 2).sum().backward()
    for t, g in zip(ts, gj):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-3, atol=1e-3)


# ---- a hybrid LM whose shared block has heads of 112 -----------------------------------

HEADS = dict(n_heads=2, n_kv_heads=2, d_head=112)


@pytest.fixture(scope="module")
def hybrid():
    jcfg = dataclasses.replace(j_reduced(j_get_config("zamba2-7b")), attn_impl="xla", **HEADS)
    tcfg = reduced(get_config("zamba2-7b"))
    tcfg = dataclasses.replace(tcfg, attn_impl="flash", embedding=dataclasses.replace(
        tcfg.embedding, lookup_impl="pallas"), **HEADS)
    jparams = j_lm.init_lm(jax.random.PRNGKey(0), jcfg)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return jcfg, tcfg, jparams, batch


def _walk(tree, jtree, fn, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            _walk(v, jtree[k], fn, path + (k,))
        elif v is not None and v.is_floating_point():
            fn("/".join(path + (k,)), v, jtree[k])


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def test_hybrid_at_head_dim_112_forward_and_loss_match_jax(hybrid):
    jcfg, tcfg, jparams, batch = hybrid
    assert tcfg.family == "hybrid" and tcfg.head_dim == 112 and tcfg.attn_impl == "flash"
    tparams = params_from_jax(jparams, device="cpu")
    jlogits, _ = jax.jit(lambda p, t: j_lm.lm_forward(p, t, jcfg))(jparams, batch["tokens"])
    before = t_ops.flash_attention.launches
    tlogits, _ = t_lm.lm_forward(tparams, torch.from_numpy(batch["tokens"]), tcfg)
    assert t_ops.flash_attention.launches == before
    _close(tlogits, jlogits, LOGITS_TOL, "logits")
    jloss = float(j_lm.lm_loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg))
    tloss = float(t_lm.lm_loss(tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
                               tcfg))
    assert abs(tloss - jloss) <= LOSS_TOL, (tloss, jloss)


def _flat(tree, jtree):
    """{path: (port leaf, JAX leaf)} over the port's float leaves."""
    out = {}
    _walk(tree, jtree, lambda path, v, j: out.__setitem__(path, (v, j)))
    return out


def _leaf_gap(got, want):
    """The worst leaf's max |got - want| / max |want| over ``want``'s leaves
    (flat dicts of arrays), in float64: each leaf against its own scale."""
    worst = 0.0
    for path, w in want.items():
        w = np.asarray(w, np.float64)
        diff = np.abs(np.asarray(got[path], np.float64) - w).max()
        scale = np.abs(w).max()
        worst = max(worst, diff / scale if scale else (0.0 if diff == 0 else np.inf))
    return worst


def _np(t):
    return t.detach().double().numpy()


def test_hybrid_at_head_dim_112_gradients_and_step_match_jax(hybrid, monkeypatch):
    """The loss's gradients against ``jax.grad`` (the shared block's sum
    over its 2 call sites included), each leaf within ``GRAD_REL`` of its
    largest entry and within the attention gradients' 1e-3; then one
    training step from JAX's state (``STEP_OPT``): loss and params after it
    within the families' bounds, and each leaf's update within ``DELTA`` of
    JAX's largest. Controls that the bounds must fail: the shared block's
    gradient from one site only, and a state left unchanged."""
    jcfg, tcfg, jparams, batch = hybrid
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jgrads = jax.grad(lambda p: j_lm.lm_loss(p, jb, jcfg), allow_int=True)(jparams)
    tparams = params_from_jax(jparams, device="cpu")
    leaves = _flat(tparams, tparams)
    for v, _ in leaves.values():
        v.requires_grad_(True)
    # each call of the shared block computes with views of its leaves, whose
    # gradients are that site's share of the leaf's
    sites, block = [], t_lm.attn_block

    def one_site(p, *args, **kw):
        views = {}

        def view(path, v):
            if not (isinstance(v, torch.Tensor) and v.is_floating_point()):
                return v
            views["/".join(path)] = w = v.view_as(v)
            if w.requires_grad:
                w.retain_grad()
            return w
        sites.append(views)
        return block(map_tree(view, p), *args, **kw)

    monkeypatch.setattr(t_lm, "attn_block", one_site)
    t_lm.lm_loss(tparams, tb, tcfg).backward()
    monkeypatch.undo()
    assert len(sites) == 2
    tgrads = {path: _np(v.grad) for path, (v, _) in leaves.items()}
    jflat = {path: np.asarray(j) for path, (_, j) in _flat(tparams, jgrads).items()}
    shared = [path for path in tgrads if path.startswith("shared/")]
    assert len(shared) == len(sites[0])
    for path, g in tgrads.items():
        np.testing.assert_allclose(g, jflat[path], rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=path)
    assert _leaf_gap(tgrads, jflat) <= GRAD_REL
    for path in shared:
        np.testing.assert_allclose(sum(_np(s[path[7:]].grad) for s in sites), tgrads[path],
                                   rtol=1e-6, atol=0, err_msg=path)
    # the control: the shared block's gradient from its first site alone
    first = dict(tgrads, **{p: _np(sites[0][p[7:]].grad) for p in shared})
    assert _leaf_gap(first, {p: jflat[p] for p in shared}) > 100 * GRAD_REL

    jstep = jax.jit(j_make_train_step(jcfg, JTrainHyper(optimizer=JAdamWConfig(**STEP_OPT),
                                                        warmup_steps=1, total_steps=4)))
    tstep = make_train_step(tcfg, TrainHyper(optimizer=AdamWConfig(**STEP_OPT), warmup_steps=1,
                                             total_steps=4))
    jstate = {"params": jparams, "opt": j_adamw_init(jparams), "step": jnp.zeros((), jnp.int32)}
    tp = params_from_jax(jparams, device="cpu")
    tstate = {"params": tp, "step": 0,
              "opt": {"step": 0, "mu": params_from_jax(jstate["opt"]["mu"], device="cpu"),
                      "nu": params_from_jax(jstate["opt"]["nu"], device="cpu")}}
    jstate, jm = jstep(jstate, jb)
    tstate, tm = tstep(tstate, tb)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL
    _walk(tstate["params"], jstate["params"], lambda path, v, j: _close(v, j, PARAMS_TOL, path))
    after = _flat(tstate["params"], jstate["params"])
    start = {path: np.asarray(j, np.float64) for path, (_, j) in _flat(tp, jparams).items()}
    d_want = {path: np.asarray(j, np.float64) - start[path] for path, (_, j) in after.items()}
    d_got = {path: _np(v) - start[path] for path, (v, _) in after.items()}
    assert _leaf_gap(d_got, d_want) <= DELTA
    # the control: a state left unchanged
    assert _leaf_gap({path: 0 * d for path, d in d_want.items()}, d_want) > 100 * DELTA

"""The hot-node decode cache (``repro_torch.core.backend``: ``CacheState``,
``CachedDecodeBackend``, ``HostCacheShadow``) against the JAX package's, on
the CPU.

Reference runs: the JAX package's ``CachedDecodeBackend`` and
``HostCacheShadow`` fed the same ids, masks, ``n_decode`` and version bumps,
with a decode function that gathers rows of a fixed table (so the values
are exact).  Inputs come from numpy seeds; a JAX cache state is carried
across with ``interop.cache_state_from_jax``.

Tolerances: everything here is integer work, sorts, gathers and scatters,
so outputs, every ``CacheState`` field, plans and the shadow are bitwise.
The one float comparison, the codebook gradient through a cached lookup,
goes through the decode's matmul-free gather-sum on both sides: within
1e-6.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import CachedDecodeBackend as JCache
from repro.core.backend import CacheState as JState
from repro.core.backend import HostCacheShadow as JShadow
from repro.train.checkpoint import CheckpointManager as JManager
from repro_torch.core import backend as tb
from repro_torch.core.backend import CachedDecodeBackend, CacheState, HostCacheShadow
from repro_torch.interop import cache_state_from_jax, params_from_jax
from repro_torch.train.checkpoint import CheckpointManager

C, U, N_IDS, D = 64, 48, 200, 8
FIELDS = ("node_ids", "values", "version", "last_used", "version_counter", "clock",
          "hits", "misses")
TABLE = np.random.default_rng(123).standard_normal((N_IDS, D)).astype(np.float32)


def _jdecode(ids):
    return jnp.asarray(TABLE)[ids]


def _tdecode(ids):
    return torch.from_numpy(TABLE)[ids.long()]


def _assert_state_equal(js, ts):
    for f in FIELDS:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def _request(rng, n_valid=None):
    """U distinct ids, the rows past ``n_valid`` padding copies of row 0."""
    ids = rng.choice(N_IDS, U, replace=False).astype(np.int32)
    n_valid = int(rng.integers(U // 2, U + 1)) if n_valid is None else n_valid
    ids[n_valid:] = ids[0]
    return ids, np.arange(U) < n_valid


def _fresh(js, staleness):
    node_ids = np.asarray(js.node_ids)
    age = int(js.version_counter) - np.asarray(js.version).astype(np.int64)
    return node_ids[age <= staleness]


@pytest.mark.parametrize("staleness", [0, 2])
def test_lookup_sequence_matches_jax(staleness):
    """Eight lookups alternating ``lookup`` and ``lookup_missonly`` (planned
    against the fresh entries, prefix padded past the miss count), with
    padding masks and a version bump after every third: outputs and every
    state field bitwise, from a state carried over from JAX."""
    rng = np.random.default_rng(staleness)
    jc, tc = JCache(staleness), CachedDecodeBackend(staleness)
    js = JState.create(C, D)
    ts = cache_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    _assert_state_equal(js, ts)
    for k in range(8):
        ids, valid = _request(rng)
        if k % 2 == 0:
            jo, js = jc.lookup(js, jnp.asarray(ids), _jdecode, valid=jnp.asarray(valid))
            to, ts = tc.lookup(ts, torch.from_numpy(ids), _tdecode,
                               valid=torch.from_numpy(valid))
        else:
            cached = _fresh(js, staleness)
            perm, n_miss = JCache.plan_missonly(cached, ids, valid)
            tperm, tn = CachedDecodeBackend.plan_missonly(cached, ids, valid)
            np.testing.assert_array_equal(tperm, perm)
            assert tn == n_miss
            n_dec = min(-(-n_miss // 8) * 8, U)
            ip, vp = ids[perm], valid[perm]
            jo, js = jc.lookup_missonly(js, jnp.asarray(ip), _jdecode, n_dec,
                                        valid=jnp.asarray(vp))
            to, ts = tc.lookup_missonly(ts, torch.from_numpy(ip), _tdecode, n_dec,
                                        valid=torch.from_numpy(vp))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo), err_msg=f"lookup {k}")
        _assert_state_equal(js, ts)
        if k % 3 == 2:
            js, ts = JCache.bump_version(js), CachedDecodeBackend.bump_version(ts)
    assert int(ts.hits) > 0 and int(ts.misses) > 0


def _both(jc, tc, js, ts, ids, valid=None, n_decode=None):
    ji, ti = jnp.asarray(ids, jnp.int32), torch.tensor(ids, dtype=torch.int32)
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.tensor(valid)
    if n_decode is None:
        jo, js = jc.lookup(js, ji, _jdecode, valid=jv)
        to, ts = tc.lookup(ts, ti, _tdecode, valid=tv)
    else:
        jo, js = jc.lookup_missonly(js, ji, _jdecode, n_decode, valid=jv)
        to, ts = tc.lookup_missonly(ts, ti, _tdecode, n_decode, valid=tv)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    _assert_state_equal(js, ts)
    return js, ts


def test_lru_eviction_and_overflow_match_jax():
    """The JAX tests' scenarios at C = 4 through both packages: LRU eviction
    keeps the touched ids; more absent misses than free slots drop the
    overflow instead of overwriting a protected slot; a miss-only call with
    ``n_decode = 0`` decodes nothing and writes nothing."""
    jc, tc = JCache(staleness=0), CachedDecodeBackend(staleness=0)
    js, ts = JState.create(4, D), CacheState.create(4, D)
    js, ts = _both(jc, tc, js, ts, [1, 2, 3, 4])
    js, ts = _both(jc, tc, js, ts, [1, 2])
    js, ts = _both(jc, tc, js, ts, [7, 8])                      # evicts 3 and 4
    assert set(ts.node_ids.tolist()) == {1, 2, 7, 8}
    js, ts = JCache.bump_version(js), CachedDecodeBackend.bump_version(ts)
    js, ts = _both(jc, tc, js, ts, [1, 2, 7, 9, 10, 11])         # overflow
    held, vals = ts.node_ids.numpy(), ts.values.numpy()
    for i, v in zip(held, vals):
        if i >= 0:
            np.testing.assert_array_equal(v, TABLE[i])
    js, ts = _both(jc, tc, js, ts, [1, 2, 7, 9], n_decode=0)     # all fresh hits
    js, ts = _both(jc, tc, js, ts, [3, 5, 5, 1], valid=[True, True, False, True],
                   n_decode=4)
    assert (int(ts.hits), int(ts.misses)) == (int(js.hits), int(js.misses))


def test_written_slots_are_distinct():
    """The write-back scatters hit distinct slots (``index_copy_`` with
    duplicate indices would pick a winner nondeterministically on CUDA), in
    random sequences with eviction and overflow; index C is the dropped
    row."""
    rng = np.random.default_rng(5)
    tc = CachedDecodeBackend(staleness=1)
    ts = CacheState.create(C, D)
    for k in range(12):
        ids, valid = _request(rng)
        tids, tvalid = torch.from_numpy(ids), torch.from_numpy(valid)
        found, slot, hit = tc._classify(ts, tids, tvalid)
        widx = tb._write_index(ts, ts.last_used, found, slot, hit, ~found & tvalid, ~hit)
        real = widx[widx < C]
        assert real.unique().numel() == real.numel(), f"lookup {k}"
        _, ts = tc.lookup(ts, tids, _tdecode, valid=tvalid)
        if k % 2:
            ts = CachedDecodeBackend.bump_version(ts)


def test_in_place_lookup_is_the_functional_one():
    """``lookup_missonly(..., buffers=)`` writes the slots in place and gives
    the functional call's outputs and state bit for bit, over planned
    lookups with eviction, padding, version bumps and repeats that decode
    nothing (``n_decode = 0``)."""
    rng = np.random.default_rng(17)
    tc = CachedDecodeBackend(staleness=1)
    ts = CacheState.create(C, D)
    buffers = CacheState.create(C + 1, D)
    ps = buffers.head(C)
    n_decodes = []
    for k in range(10):
        if k not in (4, 7):                  # 4 and 7 repeat the last request
            ids, valid = _request(rng)
        node_ids = ts.node_ids.numpy()
        age = int(ts.version_counter) - ts.version.numpy().astype(np.int64)
        perm, n_miss = CachedDecodeBackend.plan_missonly(node_ids[age <= 1], ids, valid)
        n_decode = CachedDecodeBackend.miss_bucket(n_miss, 8, U)
        n_decodes.append(n_decode)
        tids, tvalid = torch.from_numpy(ids[perm]), torch.from_numpy(valid[perm])
        a, ts = tc.lookup_missonly(ts, tids, _tdecode, n_decode, valid=tvalid)
        b, ps = tc.lookup_missonly(ps, tids, _tdecode, n_decode, valid=tvalid,
                                   buffers=buffers)
        assert torch.equal(a, b), f"lookup {k}"
        for f in FIELDS:
            assert torch.equal(getattr(ps, f), getattr(ts, f)), (k, f)
        assert ps.values.data_ptr() == buffers.values.data_ptr()
        if k % 3 == 2:
            ts, ps = CachedDecodeBackend.bump_version(ts), CachedDecodeBackend.bump_version(ps)
    assert n_decodes[4] == n_decodes[7] == 0 and min(n_decodes[:4]) > 0


def test_plan_missonly_matches_jax_and_isin():
    """The membership-table plan gives ``np.isin``'s miss set, so the JAX
    package's permutation and count bitwise (empty slots ignored)."""
    rng = np.random.default_rng(9)
    for n_ids in (10, 1000, 169_343):
        cached = rng.choice(n_ids, min(n_ids, 300), replace=False).astype(np.int32)
        cached[rng.random(cached.shape[0]) < 0.2] = -1
        ids = rng.integers(0, n_ids, 512).astype(np.int32)
        valid = rng.random(512) < 0.9
        perm, n_miss = CachedDecodeBackend.plan_missonly(cached, ids, valid)
        jperm, jn = JCache.plan_missonly(cached, ids, valid)
        np.testing.assert_array_equal(perm, jperm)
        assert perm.dtype == jperm.dtype and n_miss == jn
        assert n_miss == int((valid & ~np.isin(ids, cached[cached >= 0])).sum())
    perm, n_miss = CachedDecodeBackend.plan_missonly(np.full(4, -1, np.int32), ids)
    assert n_miss == 512 and np.array_equal(perm, np.arange(512))


@pytest.mark.parametrize("lo,hi", [(-1, 3), (-1, 169_343), (-2**30, 2**31 - 1)])
def test_shadow_sort_is_numpys_stable_argsort(lo, hi):
    """The shadow's sort (distinct int64 keys, an unstable sort) gives
    ``np.argsort(kind="stable")``'s order, ties (empty slots at
    INT32_MIN // 2, protected ones at INT32_MAX) in slot order."""
    rng = np.random.default_rng(hi)
    for n in (1, 7, 4096, 96_256):
        a = rng.integers(lo, hi, n).astype(np.int32)
        a[rng.random(n) < 0.2] = np.iinfo(np.int32).max
        a[rng.random(n) < 0.2] = np.iinfo(np.int32).min // 2
        np.testing.assert_array_equal(tb._stable_argsort(a), np.argsort(a, kind="stable"))


@pytest.mark.parametrize("staleness", [0, 4])
def test_host_shadow_matches_jax_and_the_cache_state(staleness):
    """``plan`` and ``update`` over ten steps equal the JAX shadow's, and the
    shadow equals the port's own ``CacheState`` bookkeeping after the same
    ``lookup_missonly`` + ``bump_version`` steps; ``snapshot`` /
    ``restore`` and ``sync_from_cache_state`` round-trip it."""
    rng = np.random.default_rng(40 + staleness)
    jh, th = JShadow(C, staleness), HostCacheShadow(C, staleness)
    tc, ts = CachedDecodeBackend(staleness), CacheState.create(C, D)
    for k in range(10):
        ids, valid = _request(rng)
        (jp, jn), (tp, tn) = jh.plan(ids, valid), th.plan(ids, valid)
        np.testing.assert_array_equal(tp, jp)
        assert tn == jn
        n_dec = min(tn + int(rng.integers(0, 4)), U)
        jh.update(ids[tp], valid[tp], n_dec)
        th.update(ids[tp], valid[tp], n_dec)
        _, ts = tc.lookup_missonly(ts, torch.from_numpy(ids[tp]), _tdecode, n_dec,
                                   valid=torch.from_numpy(valid[tp]))
        ts = CachedDecodeBackend.bump_version(ts)
        book = ts.bookkeeping()
        for f in ("node_ids", "version", "last_used"):
            np.testing.assert_array_equal(getattr(th, f), getattr(jh, f), err_msg=f)
            np.testing.assert_array_equal(getattr(th, f), book[f], err_msg=f)
        assert (th.clock, th.version_counter) == (jh.clock, jh.version_counter)
        assert (th.clock, th.version_counter) == (book["clock"], book["version_counter"])
        np.testing.assert_array_equal(np.sort(th.fresh_ids()), np.sort(jh.fresh_ids()))
    assert int(ts.hits) > 0 or staleness == 0
    snap = th.snapshot()
    js_snap = jh.snapshot()
    for key in js_snap:
        np.testing.assert_array_equal(np.asarray(snap[key]), np.asarray(js_snap[key]))
    other = HostCacheShadow(C, staleness)
    other.restore(js_snap)                   # the JAX snapshot's lists
    again = HostCacheShadow(C, staleness)
    again.sync_from_cache_state(ts)
    for sh in (other, again):
        for f in ("node_ids", "version", "last_used"):
            np.testing.assert_array_equal(getattr(sh, f), getattr(th, f))
        assert (sh.clock, sh.version_counter) == (th.clock, th.version_counter)
    th.clear()
    assert (th.node_ids == -1).all() and th.plan(ids, valid)[1] == int(valid.sum())
    with pytest.raises(ValueError, match="capacity"):
        HostCacheShadow(C + 1).restore(snap)


def test_gradient_flows_only_through_misses():
    """The port of the JAX package's gradient test, then the codebook
    gradient of a cached lookup over a real decode (gather-sum of
    codebooks) against JAX's: hits get none, misses get theirs."""
    tc = CachedDecodeBackend(staleness=3)
    ts = CacheState.create(4, 1)
    w = torch.tensor(2.0, requires_grad=True)
    out, ts = tc.lookup(ts, torch.tensor([5]), lambda i: w * torch.ones(1, 1))
    assert float(torch.autograd.grad(out.sum(), w)[0]) == 1.0       # fresh decode
    out, ts = tc.lookup(ts, torch.tensor([5]), lambda i: w * torch.ones(1, 1))
    assert float(torch.autograd.grad(out.sum(), w)[0]) == 0.0       # cached constant

    rng = np.random.default_rng(3)
    m, c = 4, 16
    codes = rng.integers(0, c, (N_IDS, m)).astype(np.int32)
    cb = rng.standard_normal((m, c, D)).astype(np.float32)
    g = rng.standard_normal((U, D)).astype(np.float32)
    warm = rng.choice(N_IDS, U, replace=False).astype(np.int32)
    ids = np.concatenate([warm[:U // 2], rng.choice(
        np.setdiff1d(np.arange(N_IDS), warm), U - U // 2, replace=False)]).astype(np.int32)

    def jloss(cbj, st, i):
        dec = lambda q: sum(cbj[j][jnp.asarray(codes)[q, j]] for j in range(m))
        out, st = JCache(1).lookup(st, jnp.asarray(i), dec)
        return (out * g).sum(), st

    def tloss(cbt, st, i):
        dec = lambda q: sum(cbt[j][torch.from_numpy(codes)[q.long(), j]] for j in range(m))
        out, st = CachedDecodeBackend(1).lookup(st, torch.from_numpy(i), dec)
        return (out * torch.from_numpy(g)).sum(), st

    js, ts = JState.create(C, D), CacheState.create(C, D)
    _, js = jloss(jnp.asarray(cb), js, warm)
    cbt = torch.from_numpy(cb.copy())
    _, ts = tloss(cbt, ts, warm)
    jg = jax.grad(lambda x: jloss(x, js, ids)[0])(jnp.asarray(cb))
    cbt.requires_grad_(True)
    tg = torch.autograd.grad(tloss(cbt, ts, ids)[0], cbt)[0]
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    # only the misses (the second half) carry gradient
    miss_only = np.zeros_like(cb)
    for i, b in enumerate(ids[U // 2:]):
        for j in range(m):
            miss_only[j, codes[b, j]] += g[U // 2 + i]
    np.testing.assert_allclose(tg.numpy(), miss_only, rtol=0, atol=1e-5)


def test_lookup_at_the_serving_shape_builds_no_dense_compare():
    """One ``lookup_missonly`` at the paper's served frontier (U = 61,696)
    against a full-graph cache (C = 169,343) on the CPU: a (U, C) compare
    would be 10.4 GB of bools; the sorted lookup takes well under 30 s."""
    Ub, Cb, d = 61_696, 169_343, 64
    rng = np.random.default_rng(0)
    tc = CachedDecodeBackend()
    st = dataclasses.replace(
        CacheState.create(Cb, d), version=torch.zeros(Cb, dtype=torch.int32),
        node_ids=torch.from_numpy(rng.permutation(Cb).astype(np.int32)))
    ids = torch.from_numpy(rng.permutation(Cb)[:Ub].astype(np.int32))
    t0 = time.perf_counter()
    out, st2 = tc.lookup_missonly(st, ids, lambda i: torch.zeros(i.shape[0], d), 0)
    took = time.perf_counter() - t0
    assert took < 30.0, f"lookup at the serving shape took {took:.1f} s"
    assert int(st2.hits) == Ub and out.shape == (Ub, d)


def test_cache_state_checkpoint_round_trip(tmp_path):
    """A train state holding a ``CacheState`` saves and restores bitwise;
    its leaves are keyed ``cache/0`` ... ``cache/7`` as the JAX package keys
    its pytree, so the JAX manager restores them into a JAX state too."""
    ts = CacheState.create(C, D)
    rng = np.random.default_rng(1)
    for _ in range(3):
        ids, valid = _request(rng)
        _, ts = CachedDecodeBackend(1).lookup(ts, torch.from_numpy(ids), _tdecode,
                                              valid=torch.from_numpy(valid))
    state = {"params": {"w": torch.ones(2)}, "cache": ts, "step": 3}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(3, state, {"shadow": {"ids": np.arange(3, dtype=np.int32)}})
    mgr.wait()
    template = {"params": {"w": torch.zeros(2)}, "cache": CacheState.create(C, D),
                "step": 0}
    _, back, extra = mgr.restore_latest(template)
    assert isinstance(back["cache"], CacheState) and back["step"] == 3
    for f in FIELDS:
        assert torch.equal(getattr(back["cache"], f), getattr(ts, f)), f
    assert extra["shadow"]["ids"] == [0, 1, 2]
    jtemplate = {"params": {"w": jnp.zeros(2)}, "cache": JState.create(C, D),
                 "step": jnp.zeros((), jnp.int32)}
    _, jback, _ = JManager(str(tmp_path)).restore_latest(jtemplate)
    _assert_state_equal(jback["cache"], ts)
    carried = params_from_jax(jax.tree.map(np.asarray, jback), device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(carried["cache"], f), getattr(ts, f)), f

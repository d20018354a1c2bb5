"""The port's elastic training (``repro_torch.elastic``, ``remap_shard_state``,
``rederive_owner_caps``, ``GraphRuntime.rescale`` / ``rescale_checkpoint``,
``parallel.sharding.group_mesh`` / ``broadcast_bytes``) against the JAX
package and against the port's own native runs.

Reference runs: ``tests/test_elastic.py``'s fixture, a 600-node power-law
graph (identical in both packages), the paper's GraphSAGE narrowed to c=16,
m=8, d_c=d_m=32, fanout 5, global batch 48 (divisible by 4 and by 3),
frontiers padded to 64 rows, prefetch 2, AdamW lr 1e-2.  The JAX package
runs its shards as devices of one process (its kill schedule runs below in
a subprocess with 4 forced host devices); the port runs them as 4 CPU
processes over ``gloo``, spawned once for the module (``ranks``, one thread
each), which run every multi-rank case and return what they saw.

The JAX package's 4 -> 8 checkpoint rescale becomes 4 -> 2 by
``rescale_checkpoint`` and 2 -> 4 in-process, so one spawn of 4 ranks
serves the module.

Tolerances: the wire (chunks, CRCs, stats), the failure plan, the spec
checks, the remapped state and stream, the rescaled specs and caps, and
the packed payload of the same arrays are bitwise JAX's.  The kill run is
bitwise its never-failed reference (12 steps, ``rescale(3)``, 2 steps),
every survivor's params are equal, and the rescales are bitwise native
runs.  From JAX's params at Adam's eps 1 (ROADMAP §C), the port's kill run
keeps JAX's history and report integers, and each of its 14 losses is
within 1e-5 of JAX's (f32 products summed in other orders).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch

import repro.elastic as jel
from repro.configs.paper_gnn import paper_gnn_config as j_paper_cfg
from repro.core import backend as jbackend
from repro.graph import engine as j_engine
from repro.graph import sampler as j_sampler
from repro.graph.runtime import GraphRuntime as JRuntime
from repro.graph.runtime import GraphSource as JSource
from repro.graph.runtime import RuntimeSpec as JSpec
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.train.loop import FenceInterrupt as JFenceInterrupt
import repro_torch.elastic as tel
from repro_torch.configs.paper_gnn import paper_gnn_config
from repro_torch.core import backend as tbackend
from repro_torch.elastic import (DEGRADED, HEALTHY, RESCALING, ChunkCorruption, ElasticError,
                                 ElasticManager, ElasticSpec, FailurePlan, chunk_payload,
                                 pack_state, rescale_spec, transfer_state, unpack_state)
from repro_torch.graph import engine as t_engine
from repro_torch.graph import sampler as t_sampler
from repro_torch.graph.generate import powerlaw_graph
from repro_torch.graph.runtime import GraphRuntime, GraphSource, RuntimeSpec
from repro_torch.interop import params_from_jax
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel import sharding
from repro_torch.train.checkpoint import TopologyMismatch
from repro_torch.train.loop import FenceInterrupt, LoopResult

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, BATCH, STEPS, KILL_AT = 600, 48, 14, 10
GRAPH = dict(n_nodes=N, n_classes=8, avg_degree=8, homophily=0.9)
CKPT_BATCH = 64                 # JAX's checkpoint cases: 64 divides by 4 and 2
JAX_LOSS_TOL = 1e-5


def _spec(n_shards, lookup_impl="sharded:gather", eps=1e-8, **kw) -> RuntimeSpec:
    base = paper_gnn_config("sage", n_nodes=N, n_classes=8, fanout=5)
    model = dataclasses.replace(base, embedding=dataclasses.replace(
        base.embedding, c=16, m=8, d_c=32, d_m=32, lookup_impl=lookup_impl))
    return RuntimeSpec(graph=GraphSource(**GRAPH), model=model,
                       optimizer=AdamWConfig(lr=1e-2, weight_decay=0.0, eps=eps),
                       batch_size=kw.pop("batch_size", BATCH), n_shards=n_shards, pad_to=64,
                       prefetch_depth=kw.pop("prefetch_depth", 2), total_steps=STEPS, **kw)


def _kill_plan(mod):
    return mod.FailurePlan(kill=((2, KILL_AT),), corrupt_chunks=(1,))


# ---------------------------------------------------------------------------
# in this process: bitwise against JAX
# ---------------------------------------------------------------------------

def test_exports_match_jax():
    assert set(jel.__all__) <= set(tel.__all__)
    assert (HEALTHY, DEGRADED, RESCALING) == (jel.HEALTHY, jel.DEGRADED, jel.RESCALING)


def test_failure_plan_predicates_match_jax():
    args = dict(kill=((2, 10), (0, 3)), heartbeat_delay=((1, 4, 2),), corrupt_chunks=(3, 5))
    jp, tp = jel.FailurePlan(**args), FailurePlan(**args)
    for shard in range(4):
        for step in range(14):
            assert tp.alive(shard, step) == jp.alive(shard, step)
            assert tp.delayed(shard, step) == jp.delayed(shard, step)
    for seq in range(8):
        for attempt in range(3):
            assert tp.tamper(seq, attempt) == jp.tamper(seq, attempt)
    assert not tp.alive(2, 10) and tp.alive(2, 9) and tp.tamper(3, 0) and not tp.tamper(3, 1)


def test_elastic_spec_checks_and_round_trip():
    kw = dict(lease_steps=3, min_shards=2, chunk_bytes=4096, max_transfer_retries=1,
              heartbeat_timeout_s=5.0)
    spec = ElasticSpec(**kw)
    assert ElasticSpec.from_dict(json.loads(json.dumps(spec.to_dict()))) == spec
    assert spec.to_dict() == jel.ElasticSpec(**kw).to_dict()
    for bad in (dict(lease_steps=0), dict(min_shards=0), dict(chunk_bytes=0),
                dict(max_transfer_retries=-1)):
        with pytest.raises(ValueError):
            ElasticSpec(**bad)
        with pytest.raises(ValueError):
            jel.ElasticSpec(**bad)
    # through RuntimeSpec's JSON, and from a JAX spec's
    rs = _spec(4, elastic=ElasticSpec(lease_steps=1))
    assert RuntimeSpec.from_json(rs.to_json()).elastic == ElasticSpec(lease_steps=1)
    assert RuntimeSpec.from_json(
        dataclasses.replace(rs, elastic=None).to_json()).elastic is None
    jspec = JSpec(graph=JSource(**GRAPH), model=j_paper_cfg("sage", n_nodes=N, n_classes=8),
                  elastic=jel.ElasticSpec(lease_steps=1, chunk_bytes=1 << 16))
    back = RuntimeSpec.from_json(jspec.to_json())
    assert back.elastic == ElasticSpec(lease_steps=1, chunk_bytes=1 << 16)
    assert back.to_dict() == jspec.to_dict()


@pytest.mark.parametrize("size,chunk", [(0, 64), (1, 1), (2560, 100), (5000, 1000),
                                        (65_536 * 3 + 7, 65_536)])
def test_chunks_and_transfer_stats_match_jax(size, chunk):
    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    tc, jc = chunk_payload(data, chunk), jel.chunk_payload(data, chunk)
    assert [(c.seq, c.total, c.payload, c.crc) for c in tc] == \
        [(c.seq, c.total, c.payload, c.crc) for c in jc]
    assert b"".join(c.payload for c in tc) == data and all(c.verify() for c in tc)
    assert not dataclasses.replace(tc[0], payload=b"X" + tc[0].payload[1:] + b"X").verify()
    plan = (FailurePlan(corrupt_chunks=(1, 3)), jel.FailurePlan(corrupt_chunks=(1, 3)))
    out, stats = transfer_state(data, chunk, tamper=plan[0].tamper, max_retries=2)
    jout, jstats = jel.transfer_state(data, chunk, tamper=plan[1].tamper, max_retries=2)
    assert out == jout == data
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert stats.retransmits == sum(1 for c in tc if c.seq in (1, 3))


def test_corruption_is_retried_once_and_raises_when_retries_run_out():
    data = bytes(range(256)) * 20
    out, stats = transfer_state(data, 1000, tamper=FailurePlan(corrupt_chunks=(1, 3)).tamper)
    assert out == data and stats.chunks == 6 and stats.retransmits == 2
    assert stats.bytes_transferred == len(data) + 2 * 1000
    always = lambda seq, attempt: seq == 0
    for mod in (tel, jel):
        with pytest.raises(mod.ChunkCorruption, match="chunk 0"):
            mod.transfer_state(b"abcdef", chunk_bytes=2, tamper=always, max_retries=1)
        with pytest.raises(mod.ChunkCorruption):
            mod.transfer_state(b"abcdef", chunk_bytes=2,
                               tamper=mod.FailurePlan(corrupt_chunks=(0,)).tamper, max_retries=0)


def _tree(lib):
    """One state in both packages' leaf types, keys in sorted order (JAX
    flattens dicts by sorted key)."""
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    m = np.full((5,), 0.25)
    if lib is np:
        return {"opt": {"m": m}, "params": {"w": w}, "step": np.asarray(7, np.int32)}
    return {"opt": {"m": torch.from_numpy(m)}, "params": {"w": torch.from_numpy(w)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_pack_unpack_round_trip_and_bytes():
    extra = {"source": {"step": 9, "seed": 3}}
    payload = pack_state(_tree(torch), extra)
    assert payload == pack_state(_tree(torch), extra)          # two packs, one set of bytes
    assert payload == jel.pack_state(_tree(np), extra)         # JAX's payload, byte for byte
    template = {"opt": {"m": torch.zeros(5, dtype=torch.float64)},
                "params": {"w": torch.zeros(3, 4, dtype=torch.bfloat16)},
                "step": torch.tensor(0, dtype=torch.int32)}
    out, got_extra = unpack_state(payload, template)
    assert got_extra == extra
    assert torch.equal(out["opt"]["m"], _tree(torch)["opt"]["m"])
    assert out["params"]["w"].dtype == torch.bfloat16          # the template's dtype
    assert torch.equal(out["params"]["w"].float(), _tree(torch)["params"]["w"])
    assert int(out["step"]) == 7
    # a bf16 leaf packs as its bits and comes back unchanged
    bf = {"x": torch.randn(4, 3).to(torch.bfloat16)}
    assert torch.equal(unpack_state(pack_state(bf), {"x": torch.zeros(4, 3, dtype=torch.bfloat16)})
                       [0]["x"], bf["x"])
    bad = _tree(torch)
    bad["params"]["w"] = torch.zeros(2, 2)
    with pytest.raises(ValueError, match="shape mismatch"):
        unpack_state(payload, bad)
    with pytest.raises(KeyError, match="missing leaf"):
        unpack_state(payload, {"params": {"extra_leaf": torch.zeros(3)}})


def test_remap_shard_state_matches_jax():
    state = {"step": 12, "seed": 5, "n_shards": 4, "miss_shadow": {"x": 1}}
    for n, shard in ((3, 0), (1, 0), (8, 2)):
        out = t_sampler.remap_shard_state(state, n, shard=shard)
        assert out == j_sampler.remap_shard_state(state, n, shard=shard)
    assert t_sampler.remap_shard_state(state, 3) == {"step": 12, "seed": 5, "shard": 0,
                                                     "n_shards": 3}


def test_batch_sources_take_a_remapped_state_at_one_and_at_n_shards():
    adj, labels = powerlaw_graph(0, N, avg_degree=8, n_classes=8, homophily=0.9)
    smp = t_sampler.NeighborSampler(adj, (5, 5), max_deg=32, seed=0)
    state = {"step": 7, "seed": 0, "n_shards": 4}
    one = t_engine.SageBatchSource(smp, np.arange(N), labels, BATCH, seed=0, pad_to=64)
    one.load_state_dict(t_sampler.remap_shard_state(state, 1))
    three = t_engine.ShardedSageBatchSource(smp, np.arange(N), labels, BATCH // 3, n_shards=3,
                                            seed=0, pad_to=64)
    three.load_state_dict(t_sampler.remap_shard_state(state, 3))
    assert one.step == 7 and three.state_dict() == {"step": 7, "seed": 0, "n_shards": 3}
    with pytest.raises(ValueError):
        three.load_state_dict(t_sampler.remap_shard_state(state, 4))


def test_remapped_union_stream_is_exact_and_jax_s():
    """The global batch at (seed, step) does not depend on the shard count:
    the 4-shard union of the shards' batches is the 3-shard one and the
    1-shard batch, and JAX's."""
    adj, labels = powerlaw_graph(0, N, avg_degree=8, n_classes=8)
    samplers = {mod: mod.NeighborSampler(adj, (5, 5), max_deg=32, seed=0)
                for mod in (t_sampler, j_sampler)}
    nodes = np.arange(N, dtype=np.int32)

    def union(engine, sampler_mod, n_shards, step):
        got = []
        for shard in range(n_shards):
            src = engine.SageBatchSource(samplers[sampler_mod], nodes, labels, BATCH // n_shards,
                                         seed=0, shard=shard, n_shards=n_shards, dedup=False)
            src.load_state_dict(sampler_mod.remap_shard_state({"step": step, "seed": 0},
                                                              n_shards, shard=shard))
            got.append(np.asarray(src.next_batch()["levels"][0]))
        return np.concatenate(got)

    for step in (7, 12):
        four = union(t_engine, t_sampler, 4, step)
        np.testing.assert_array_equal(four, union(t_engine, t_sampler, 3, step))
        np.testing.assert_array_equal(four, union(t_engine, t_sampler, 1, step))
        np.testing.assert_array_equal(four, union(j_engine, j_sampler, 3, step))


def test_rescale_spec_and_rederive_owner_caps_match_jax():
    jspec = JSpec(graph=JSource(**GRAPH), model=j_paper_cfg("sage", n_nodes=N, n_classes=8),
                  batch_size=BATCH, n_shards=4, ckpt_dir="/tmp/old")
    tspec = RuntimeSpec.from_json(jspec.to_json())
    for caps in ((None, None), (256, 256), (None, 64)):
        for cap in (None, 512):
            for n in (1, 2, 3, 6):
                kw = dict(frontier_cap=cap, owner_cap=caps[0], owner_unique_cap=caps[1])
                got = rescale_spec(dataclasses.replace(tspec, **kw), n)
                want = jel.rescale_spec(dataclasses.replace(jspec, **kw), n)
                assert got.to_dict() == want.to_dict()
    out = rescale_spec(tspec, 3)
    assert (out.n_shards, out.batch_size, out.ckpt_dir, out.owner_cap) == (3, BATCH, None, None)
    for bad in (5, 0):
        with pytest.raises(ValueError) as te:
            rescale_spec(tspec, bad)
        with pytest.raises(ValueError) as je:
            jel.rescale_spec(jspec, bad)
        assert str(te.value) == str(je.value)
    for cap in (512, 11_776, 23_296):
        for n in (1, 2, 3, 4, 8):
            for explicit in ((None, None), (8, None), (None, 8), (8, 8)):
                assert (tbackend.rederive_owner_caps(cap, n, explicit)
                        == jbackend.rederive_owner_caps(cap, n, explicit))
    assert tbackend.rederive_owner_caps(23_296, 2, (3_680, 5_888)) == (14_560, 11_648)


# ---------------------------------------------------------------------------
# the manager on stub runtimes (JAX's tests/test_elastic.py:154-258)
# ---------------------------------------------------------------------------

class _StubRuntime:
    """Duck-typed GraphRuntime: ``train`` walks steps and honours the fence;
    the state is a tiny tree, so pack, transfer and unpack run for real."""

    def __init__(self, n_shards=4, elastic=None):
        self.spec = types.SimpleNamespace(n_shards=n_shards, ckpt_dir=None, elastic=elastic,
                                          batch_size=BATCH)
        self.state = {"w": torch.zeros(3)}
        self.data_iter = types.SimpleNamespace(
            state_dict=lambda: {"step": 0, "seed": 0, "n_shards": n_shards})
        self.closed = False

    def train(self, steps, on_metrics=None, fence=None):
        interrupted, losses = None, []
        for step in range(int(steps)):
            losses.append(0.0)
            if fence is not None:
                try:
                    fence(step)
                except (FenceInterrupt, JFenceInterrupt):
                    interrupted = step + 1
                    break
        return LoopResult(state=self.state, losses=losses, step_times=[], stragglers=0,
                          resumed_from=None, interrupted_at=interrupted)

    def close(self):
        self.closed = True


def _stub_manager(plan, n_shards=4, **spec_kw):
    mgr = ElasticManager(_StubRuntime(n_shards=n_shards), plan=plan,
                         spec=ElasticSpec(lease_steps=1, **spec_kw))

    def recover_stub():
        dead, detected = mgr._pending
        mgr._pending = None
        mgr._consumed.update((s, at) for s, at in mgr.plan.kill if at <= detected)
        n_after = mgr.n_shards - len(dead)
        if n_after < mgr.spec.min_shards:
            raise ElasticError("survivors < min_shards")
        payload = pack_state(mgr.rt.state, {"source": mgr.rt.data_iter.state_dict()})
        wire, _ = transfer_state(payload, chunk_bytes=mgr.spec.chunk_bytes,
                                 tamper=mgr.plan.tamper,
                                 max_retries=mgr.spec.max_transfer_retries)
        mgr.state = RESCALING
        mgr.history.append(RESCALING)
        new_rt = _StubRuntime(n_shards=n_after)
        new_rt.state, _ = unpack_state(wire, new_rt.state)
        mgr.rt.close()
        mgr.rt, mgr.n_shards = new_rt, n_after
        mgr._leases = {s: mgr._done - 1 for s in range(n_after)}
        mgr.state = HEALTHY
        mgr.history.append(HEALTHY)
    mgr._recover = recover_stub
    return mgr


def test_manager_detects_kill_and_rescales():
    mgr = _stub_manager(FailurePlan(kill=((2, 10),)))
    res = mgr.run(20)
    assert res.steps == 20 and len(res.losses) == 20
    assert mgr.n_shards == 3 and mgr.state == HEALTHY
    assert res.history == [HEALTHY, DEGRADED, RESCALING, HEALTHY]


def test_manager_healthy_run_never_transitions():
    res = _stub_manager(None).run(5)
    assert res.history == [HEALTHY] and res.steps == 5


def test_manager_tolerates_short_heartbeat_delay():
    mgr = _stub_manager(FailurePlan(heartbeat_delay=((1, 4, 1),)))
    assert mgr.run(10).history == [HEALTHY] and mgr.n_shards == 4
    assert DEGRADED in _stub_manager(FailurePlan(heartbeat_delay=((1, 4, 3),))).run(10).history


def test_manager_min_shards_floor():
    mgr = _stub_manager(FailurePlan(kill=((0, 2), (1, 2), (2, 2))), min_shards=2)
    with pytest.raises(ElasticError):
        mgr.run(10)


def test_manager_refuses_checkpointed_runtime():
    rt = _StubRuntime()
    rt.spec.ckpt_dir = "/tmp/somewhere"
    with pytest.raises(ValueError, match="rescale_checkpoint"):
        ElasticManager(rt)


def _stub_recover(mgr):
    """The bookkeeping of a recovery alone, on either package's manager."""
    dead, detected = mgr._pending
    mgr.detections.append((dead, detected))
    mgr._pending = None
    mgr._consumed.update((s, at) for s, at in mgr.plan.kill if at <= detected)
    mgr.n_shards -= len(dead)
    mgr.history += [RESCALING, HEALTHY]
    mgr.rt = _StubRuntime(n_shards=mgr.n_shards)
    mgr._leases = {s: mgr._done - 1 for s in range(mgr.n_shards)}


def test_manager_fences_match_jax_s_over_two_kills():
    """Two kills in one plan, the second addressing the renumbered shards,
    and a delay: the same fences, detections, histories and shard counts as
    the JAX package's manager."""
    plan = dict(kill=((2, 3), (0, 8)), heartbeat_delay=((1, 5, 1),))
    got = []
    for mod in (tel, jel):
        mgr = mod.ElasticManager(_StubRuntime(), plan=mod.FailurePlan(**plan),
                                 spec=mod.ElasticSpec(lease_steps=1))
        mgr.detections = []
        mgr._recover = lambda mgr=mgr: _stub_recover(mgr)
        res = mgr.run(12)
        got.append((res.history, mgr.detections, mgr.n_shards, res.steps, len(res.losses)))
    assert got[0] == got[1] and got[0][2] == 2 and len(got[0][1]) == 2


# ---------------------------------------------------------------------------
# four ranks over gloo, spawned once
# ---------------------------------------------------------------------------

def _np_params(rt):
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            elif isinstance(v, torch.Tensor):
                out[prefix + k] = v.detach().cpu().numpy().copy()
    walk(rt.params, "")
    return out


def _kill_run(spec, plan=None, **kw):
    rt = GraphRuntime.from_spec(spec, device="cpu", **kw)
    mgr = ElasticManager(rt, plan=plan or _kill_plan(tel))
    res = mgr.run(STEPS)
    out = dict(history=res.history, reports=[dataclasses.asdict(r) for r in res.reports],
               losses=res.losses, steps=res.steps, alive=res.runtime is not None)
    if res.runtime is not None:
        out.update(params=_np_params(res.runtime), n_shards=res.runtime.spec.n_shards,
                   ckpt_dir=res.runtime.spec.ckpt_dir)
        res.runtime.close()
    return out


def _pinned(n, **kw):
    """An ``owner:gather`` spec with its caps pinned at the default for its
    frontier cap (the chip's case (b))."""
    spec = _spec(n, "owner:gather", batch_size=CKPT_BATCH, **kw)
    cap = t_engine.default_frontier_cap(CKPT_BATCH // n, spec.model.fanouts, 64, N)
    oc, ou = t_sampler.default_owner_caps(cap, n)
    return dataclasses.replace(spec, owner_cap=oc, owner_unique_cap=ou)


def _rank_program(rank, case):
    torch.set_num_threads(1)
    out = {}
    # (a) kill shard 2 at step 10, recover from the peers, continue on 3;
    # the reference: a never-failed run to the interrupt, rescale(3), 2 more
    elastic = ElasticSpec(lease_steps=1, chunk_bytes=1 << 16)
    spec = _spec(4, elastic=elastic)
    out["kill"] = _kill_run(spec)
    rt4 = GraphRuntime.from_spec(spec, device="cpu")
    head = rt4.train(KILL_AT + 2).losses
    payload = pack_state(rt4.state, {"source": rt4.data_iter.state_dict()})
    out["packed"] = (len(payload),
                     payload == pack_state(rt4.state, {"source": rt4.data_iter.state_dict()}))
    rt3 = rt4.rescale(3)
    rt4.close()
    out["ref"] = None
    if rt3 is not None:
        out["ref"] = (head + rt3.train(2).losses, _np_params(rt3))
        rt3.close()
    # two kills: shard 2 at step 4, then the renumbered shard 0 (world rank
    # 0) at step 9; the reference rescales by hand at the same steps
    out["two_kills"] = _kill_run(spec, plan=FailurePlan(kill=((2, 4), (0, 9))))
    rt4 = GraphRuntime.from_spec(spec, device="cpu")
    losses = rt4.train(6).losses
    rt3 = rt4.rescale(3)
    rt4.close()
    rt2 = None
    if rt3 is not None:
        losses += rt3.train(5).losses
    # every world rank takes part in the next group build
    rt2 = tel.rescale_runtime(rt3, 2, device="cpu")
    if rt3 is not None:
        rt3.close()
    out["two_kills_ref"] = None
    if rt2 is not None:
        out["two_kills_ref"] = (losses + rt2.train(3).losses, _np_params(rt2))
        rt2.close()
    # JAX's params at Adam's eps 1, the same plan
    out["jax_plan"] = _kill_run(_spec(4, eps=1.0, elastic=elastic),
                                params=params_from_jax(case["jax_params"], device="cpu"))
    # a heartbeat delay inside the lease grace; a floor on the survivors
    rt = GraphRuntime.from_spec(_spec(4, prefetch_depth=0), device="cpu")
    res = ElasticManager(rt, plan=FailurePlan(heartbeat_delay=((1, 2, 1),)),
                         spec=ElasticSpec(lease_steps=1)).run(4)
    out["delay"] = (res.history, res.runtime.spec.n_shards, res.runtime is rt, len(res.losses))
    rt.close()
    rt = GraphRuntime.from_spec(_spec(4, prefetch_depth=0), device="cpu")
    try:
        ElasticManager(rt, plan=FailurePlan(kill=((0, 2), (1, 2), (2, 2))),
                       spec=ElasticSpec(lease_steps=1, min_shards=2)).run(6)
        out["min_shards"] = None
    except ElasticError as e:
        out["min_shards"] = str(e)
    finally:
        rt.close()
    # (b) a 4-rank checkpoint at step 0 rescaled to 2 ranks, one step; a
    # native 2-rank run of the same init
    ck = case["ckpt_dir"]
    rt = GraphRuntime.from_spec(_pinned(4, ckpt_dir=ck), device="cpu")
    rt.train(0)
    rt.close()
    rt = GraphRuntime.rescale_checkpoint(ck, 2, device="cpu")
    out["from_ckpt"] = None
    if rt is not None:
        out["from_ckpt"] = (rt.train(1).losses, (rt.spec.owner_cap, rt.spec.owner_unique_cap),
                            rt.spec.n_shards, rt.spec.ckpt_dir)
        rt.close()
    mesh2 = sharding.group_mesh([0, 1], device="cpu")
    out["native2"] = out["mismatch"] = None
    if mesh2 is not None:
        rt = GraphRuntime.from_spec(_pinned(2), device="cpu", group=mesh2.group)
        out["native2"] = (rt.train(1).losses, (rt.spec.owner_cap, rt.spec.owner_unique_cap))
        rt.close()
        # a 2-rank spec pointed at the 4-rank checkpoint
        bad = GraphRuntime.from_spec(_pinned(2, ckpt_dir=ck), device="cpu", group=mesh2.group)
        try:
            bad.train(4)
        except TopologyMismatch as e:
            out["mismatch"] = str(e)
        finally:
            bad.close()
    # (c) a native 2-rank runtime taken to 4 ranks at step 0, one step; a
    # native 4-rank run
    if mesh2 is not None:
        rt2 = GraphRuntime.from_spec(_spec(2, batch_size=CKPT_BATCH), device="cpu",
                                     group=mesh2.group)
        grown = rt2.rescale(4)
        rt2.close()
    else:
        grown = tel.rescale_runtime(None, 4, device="cpu")
    out["grown"] = (grown.train(1).losses, grown.spec.n_shards, grown.mesh.size,
                    _np_params(grown))
    try:
        grown.rescale(5)
        out["five"] = None
    except ValueError as e:
        out["five"] = str(e)
    grown.close()
    native = GraphRuntime.from_spec(_spec(4, batch_size=CKPT_BATCH), device="cpu")
    out["native4"] = native.train(1).losses
    native.close()
    # the byte broadcast from group rank 1 of [0, 1, 3], a chunk corrupted
    # once, and one corrupted on every try
    mesh3 = sharding.group_mesh([0, 1, 3], device="cpu")
    out["broadcast"] = None
    if mesh3 is not None:
        data = case["bytes"] if mesh3.rank == 1 else None
        got, stats = sharding.broadcast_bytes(data, mesh3, src=1, chunk_bytes=1000,
                                              tamper=FailurePlan(corrupt_chunks=(1, 3)).tamper)
        try:
            sharding.broadcast_bytes(data, mesh3, src=1, chunk_bytes=1000,
                                     tamper=lambda seq, attempt: seq == 2, max_retries=1)
            raised = None
        except ChunkCorruption as e:
            raised = str(e)
        out["broadcast"] = (got, dataclasses.asdict(stats), raised)
    out["transport"] = sharding.group_mesh(range(4), device="cpu").backend
    return out


def _jcfg():
    base = j_paper_cfg("sage", n_nodes=N, n_classes=8, fanout=5)
    return dataclasses.replace(base, embedding=dataclasses.replace(
        base.embedding, c=16, m=8, d_c=32, d_m=32, lookup_impl="sharded:gather"))


_JAX_KILL = """
import dataclasses, json
from repro.configs.paper_gnn import paper_gnn_config
from repro.elastic import ElasticManager, ElasticSpec, FailurePlan
from repro.graph.runtime import GraphRuntime, GraphSource, RuntimeSpec
from repro.optim.adamw import AdamWConfig
base = paper_gnn_config("sage", n_nodes={N}, n_classes=8, fanout=5)
model = dataclasses.replace(base, embedding=dataclasses.replace(
    base.embedding, c=16, m=8, d_c=32, d_m=32, lookup_impl="sharded:gather"))
spec = RuntimeSpec(graph=GraphSource(**{GRAPH}), model=model,
                   optimizer=AdamWConfig(lr=1e-2, weight_decay=0.0, eps=1.0),
                   batch_size={BATCH}, n_shards=4, pad_to=64, prefetch_depth=2,
                   total_steps={STEPS}, elastic=ElasticSpec(lease_steps=1, chunk_bytes=1 << 16))
rt = GraphRuntime.from_spec(spec)
res = ElasticManager(rt, plan=FailurePlan(kill=((2, {KILL_AT}),), corrupt_chunks=(1,))).run({STEPS})
print("RESULT", json.dumps(dict(history=res.history, steps=res.steps, losses=res.losses,
                                reports=[dataclasses.asdict(r) for r in res.reports])))
res.runtime.close()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start JAX's kill schedule in a subprocess, run the 4 ranks, and hand
    both results to the tests."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    code = textwrap.dedent(_JAX_KILL).format(N=N, GRAPH=GRAPH, BATCH=BATCH, STEPS=STEPS,
                                             KILL_AT=KILL_AT)
    jproc = subprocess.Popen([sys.executable, "-c", code], env=env, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    jspec = JSpec(graph=JSource(**GRAPH), model=_jcfg(), batch_size=BATCH, pad_to=64,
                  optimizer=JAdamW(lr=1e-2, weight_decay=0.0, eps=1.0), prefetch_depth=0)
    jrt = JRuntime.from_spec(jspec)
    try:
        jax_params = jax.tree.map(np.asarray, jrt.state["params"])
    finally:
        jrt.close()
    case = dict(ckpt_dir=str(tmp_path_factory.mktemp("ck4")), jax_params=jax_params,
                bytes=np.random.default_rng(3).integers(0, 256, 4_500, np.uint8).tobytes())
    try:
        results = sharding.spawn(_rank_program, 4, args=(case,), timeout_s=600)
    finally:
        out, err = jproc.communicate(timeout=600)
    assert jproc.returncode == 0, err
    jres = json.loads(next(l for l in out.splitlines() if l.startswith("RESULT"))[7:])
    return results, jres


def test_kill_run_is_its_reference_bitwise(ranks):
    results, _ = ranks
    kills = [r["kill"] for r in results]
    survivors = [k for k in kills if k["alive"]]
    assert [k["alive"] for k in kills] == [True, True, False, True]
    ref_losses, ref_params = results[0]["ref"]
    for k in survivors:
        assert k["history"] == [HEALTHY, DEGRADED, RESCALING, HEALTHY]
        assert k["steps"] == STEPS and k["losses"] == ref_losses
        assert (k["n_shards"], k["ckpt_dir"]) == (3, None)
        assert k["params"].keys() == ref_params.keys()
        assert all(np.array_equal(k["params"][p], ref_params[p]) for p in ref_params)
    for r in results[1:3]:                       # the reference's own ranks agree
        assert r["ref"][0] == ref_losses
    (rep,) = survivors[0]["reports"]
    assert all(k["reports"] == [rep] for k in survivors)
    assert rep["failed_shards"] == (2,) and rep["detected_at_step"] == KILL_AT + 1
    assert rep["steps_lost"] == 1 and (rep["n_before"], rep["n_after"]) == (4, 3)
    assert rep["retransmits"] == 1 and rep["bytes_transferred"] > rep["payload_bytes"]
    assert rep["chunks"] == -(-rep["payload_bytes"] // (1 << 16))


def test_the_killed_rank_leaves_with_its_losses(ranks):
    dead = ranks[0][2]["kill"]
    assert not dead["alive"] and dead["history"] == [HEALTHY, DEGRADED]
    assert dead["steps"] == KILL_AT + 2 and dead["reports"] == []
    assert dead["losses"] == ranks[0][0]["kill"]["losses"][:KILL_AT + 2]


def test_payload_is_the_packed_state_and_packs_are_byte_equal(ranks):
    results, _ = ranks
    size, same = results[0]["packed"]
    assert same and all(r["packed"] == (size, True) for r in results)
    assert results[0]["kill"]["reports"][0]["payload_bytes"] == size


def test_kill_schedule_against_jax(ranks):
    """From JAX's params at Adam's eps 1: JAX's history, report integers
    (bytes aside: the port's leaves are its own) and losses."""
    results, jres = ranks
    got = results[0]["jax_plan"]
    assert got["history"] == jres["history"] and got["steps"] == jres["steps"]
    (rep,), (jrep,) = got["reports"], jres["reports"]
    for key in ("detected_at_step", "steps_lost", "n_before", "n_after", "retransmits"):
        assert rep[key] == jrep[key], key
    assert list(rep["failed_shards"]) == jrep["failed_shards"]
    assert rep["payload_bytes"] == results[0]["packed"][0]
    assert len(got["losses"]) == len(jres["losses"]) == STEPS
    gaps = [abs(a - b) for a, b in zip(got["losses"], jres["losses"])]
    assert max(gaps) <= JAX_LOSS_TOL, gaps


def test_short_heartbeat_delay_is_tolerated(ranks):
    for r in ranks[0]:
        assert r["delay"] == ([HEALTHY], 4, True, 4)


def test_min_shards_raises_on_every_rank(ranks):
    for r in ranks[0]:
        assert r["min_shards"] is not None and "min_shards=2" in r["min_shards"]


def test_checkpoint_rescaled_4_to_2_is_a_native_run(ranks):
    results, _ = ranks
    assert results[2]["from_ckpt"] is None and results[3]["from_ckpt"] is None
    for r in results[:2]:
        losses, caps, n, ckpt_dir = r["from_ckpt"]
        assert (n, ckpt_dir) == (2, None)
        assert losses == r["native2"][0]
        assert caps == r["native2"][1]


def test_grow_2_to_4_in_process_is_a_native_run(ranks):
    results, _ = ranks
    for r in results:
        losses, n, size, params = r["grown"]
        assert (n, size) == (4, 4) and losses == r["native4"]
        assert all(np.array_equal(params[k], results[0]["grown"][3][k]) for k in params)
        assert "not divisible" in r["five"]
    assert results[0]["transport"] == "gloo"


def test_topology_mismatch_names_rescale(ranks):
    results, _ = ranks
    for r in results[:2]:
        assert "GraphRuntime.rescale" in r["mismatch"]


def test_byte_broadcast_checks_every_chunk(ranks):
    results, _ = ranks
    data = np.random.default_rng(3).integers(0, 256, 4_500, np.uint8).tobytes()
    _, want = transfer_state(data, 1000, tamper=FailurePlan(corrupt_chunks=(1, 3)).tamper)
    assert results[2]["broadcast"] is None
    for r in (results[0], results[1], results[3]):
        got, stats, raised = r["broadcast"]
        assert got == data and stats == dataclasses.asdict(want)
        assert raised is not None and "chunk 2/5" in raised


def test_two_kills_compose(ranks):
    """A second kill addresses the survivors' new shard ids; the rank
    killed first keeps taking part in the group builds."""
    results, _ = ranks
    runs = [r["two_kills"] for r in results]
    assert [k["alive"] for k in runs] == [False, True, False, True]
    ref_losses, ref_params = results[0]["two_kills_ref"]
    assert results[1]["two_kills_ref"][0] == ref_losses
    for k in (runs[1], runs[3]):
        assert k["history"] == [HEALTHY, DEGRADED, RESCALING, HEALTHY, DEGRADED, RESCALING,
                                HEALTHY]
        assert k["losses"] == ref_losses and k["n_shards"] == 2
        assert all(np.array_equal(k["params"][p], ref_params[p]) for p in ref_params)
        assert [(r["failed_shards"], r["detected_at_step"], r["n_after"])
                for r in k["reports"]] == [((2,), 5, 3), ((0,), 10, 2)]
    assert runs[2]["steps"] == 6 and runs[0]["steps"] == 11
    assert runs[0]["losses"] == ref_losses[:11]

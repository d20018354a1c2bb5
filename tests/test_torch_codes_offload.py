"""Codes kept on the host (``codes_placement="host"``) in the port, against
the JAX package and against the port's own device placement.

Reference runs: ``tests/test_codes_offload.py``'s size, a 1,200-node
power-law graph (identical in both packages), the paper's GraphSAGE
narrowed to c=16, m=8, d_c=d_m=64, fanout 5, batch 64, AdamW lr 1e-2.  The
JAX runtime decodes with ``gather``; the port with its kernel backend
(``pallas``: on CPU tensors the kernel's plain version, whose backward sums
in a fixed order, as the port's ``gather`` backend's does since its ROADMAP
§C repair, ``tests/test_torch_decode.py``).

Tolerances: frontiers, code rows and producer byte counts are numpy, so
bitwise against JAX.  Host placement against the port's device placement
is bitwise everywhere: losses, params, ``evaluate``, ``embed``, served
rows, resume.  The port's host run against JAX's host run, each step from
JAX's state: losses within 1e-5, params within 1e-4 (the bounds of the
port's other runtime tests: f32 matmuls summed in other orders).  The
4-shard case of the JAX file is ``tests/test_torch_sharded.py``'s
``test_variants_are_the_plain_run_bitwise[...-host]``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_gnn import paper_gnn_config as j_paper_cfg
from repro.graph.runtime import GraphRuntime as JRuntime
from repro.graph.runtime import GraphSource as JSource
from repro.graph.runtime import RuntimeSpec as JSpec
from repro.graph.sampler import attach_codes as j_attach_codes
from repro.graph import engine as j_engine
from repro.graph.sampler import NeighborSampler as JSampler
from repro.optim.adamw import AdamWConfig as JAdamW
from repro_torch.benchmarks import codes_offload as bench
from repro_torch.core import codes as codes_lib
from repro_torch.core import embedding as temb
from repro_torch.graph import engine as t_engine
from repro_torch.graph.runtime import GraphRuntime, RuntimeSpec
from repro_torch.graph.sampler import FrontierBatch, NeighborSampler, attach_codes
from repro_torch.interop import params_from_jax
from repro_torch.nn.module import leaves_with_path
from repro_torch.serving.batcher import BatchingSpec

N, BATCH = 1200, 64
LOSS_TOL, PARAM_TOL = 1e-5, 1e-4
GRAPH = dict(kind="powerlaw", seed=0, n_nodes=N, n_classes=8, avg_degree=8, homophily=0.9)


def _jspec(**kw):
    base = j_paper_cfg("sage", n_nodes=N, n_classes=8, fanout=5)
    cfg = dataclasses.replace(base, embedding=dataclasses.replace(
        base.embedding, c=16, m=8, d_c=64, d_m=64, lookup_impl="gather"))
    spec = JSpec(graph=JSource(**GRAPH), model=cfg,
                 optimizer=JAdamW(lr=1e-2, weight_decay=0.0), batch_size=BATCH,
                 prefetch_depth=0)
    return spec.with_updates(**kw) if kw else spec


def _spec(**kw) -> RuntimeSpec:
    """The JAX spec's JSON on the port's kernel backend."""
    return RuntimeSpec.from_json(_jspec().to_json()).with_updates(**{"lookup_impl": "pallas",
                                                                     **kw})


@pytest.fixture(scope="module")
def graph():
    adj, labels = _spec().graph.build()
    return adj, labels


@pytest.fixture(scope="module")
def jhost():
    """JAX's host-placed runtime: its params carry no codes, its numpy
    buffer is ``codes``."""
    rt = JRuntime.from_spec(_jspec(codes_placement="host"))
    yield rt
    rt.close()


def _pair(graph, **kw):
    """A device-placed and a host-placed port runtime from one seed."""
    dev = GraphRuntime.from_spec(_spec(**kw), graph=graph, device="cpu")
    host = GraphRuntime.from_spec(_spec(codes_placement="host", **kw), graph=graph,
                                  device="cpu")
    return dev, host


def _same_params(a, b) -> bool:
    la, lb = dict(leaves_with_path(a)), dict(leaves_with_path(b))
    lb.pop(("embed", "codes_buf"), None)
    la.pop(("embed", "codes_buf"), None)
    return la.keys() == lb.keys() and all(torch.equal(la[k], lb[k]) for k in la)


def _np(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


# ---------------- the batch's code rows ----------------

def test_attach_codes_rows_match_jax(graph, jhost):
    """The port's ``attach_codes`` on the port's frontier gives JAX's rows
    on JAX's frontier, bitwise, row-aligned with ``unique``; a batch that
    has its rows is returned as it is."""
    trt = GraphRuntime.from_spec(_spec(codes_placement="host"), graph=graph, device="cpu",
                                 codes=jhost.codes)
    jfb = jhost.source.next_batch()["frontier"]
    tfb = trt.source.next_batch()["frontier"]
    np.testing.assert_array_equal(np.asarray(tfb.unique), np.asarray(jfb.unique))
    mine, ref = attach_codes(tfb, trt.codes), j_attach_codes(jfb, jhost.codes)
    assert mine.codes.dtype == np.uint32 and mine.codes.shape == (len(tfb.unique), 1)
    np.testing.assert_array_equal(mine.codes, np.asarray(ref.codes))
    np.testing.assert_array_equal(mine.codes, trt.codes[np.asarray(tfb.unique)])
    assert attach_codes(mine, trt.codes) is mine
    trt.close()


def test_host_params_carry_no_codes_buf(graph, jhost):
    """Host-placed params hold only the decoder: JAX's leaves, and the
    seeded port decoder is the device placement's bit for bit; the
    runtime's ``codes`` is the numpy uint32 buffer the device run holds as
    int64 words."""
    dev, host = _pair(graph)
    assert "codes_buf" in dev.params["embed"] and "codes_buf" not in host.params["embed"]
    assert "codes_buf" not in jhost.params["embed"]
    mine = {k: tuple(t.shape) for k, t in leaves_with_path(host.params)}
    ref = {k: tuple(t.shape) for k, t in leaves_with_path(params_from_jax(
        _np(jhost.params), device="cpu"))}
    assert mine == ref
    assert _same_params(dev.params, host.params)
    assert host.codes_on_host and not dev.codes_on_host
    assert isinstance(host.codes, np.ndarray) and host.codes.dtype == np.uint32
    np.testing.assert_array_equal(host.codes, codes_lib.to_uint32(dev.codes))
    dev.close()
    host.close()


def test_embed_lookup_and_decode_all_with_host_codes(graph):
    """``embed_lookup(codes=)`` (uint32 rows or int64 words) and
    ``decode_all(host_codes=)`` give the ``codes_buf`` gather's bits."""
    dev, host = _pair(graph)
    dcfg, hcfg = dev.cfg.embedding_config(), host.cfg.embedding_config()
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, N, 300))
    want = temb.embed_lookup(dev.params["embed"], ids, dcfg)
    rows = host.codes[ids.numpy()]
    for codes in (rows, codes_lib.from_uint32(rows)):
        assert torch.equal(temb.embed_lookup(host.params["embed"], ids, hcfg, codes=codes), want)
    assert torch.equal(temb.decode_all(host.params["embed"], hcfg, block=256,
                                       host_codes=host.codes),
                       temb.decode_all(dev.params["embed"], dcfg, block=256))
    dev.close()
    host.close()


def test_high_bit_words_keep_their_bit_patterns():
    """A uint32 word at or above 2**31 reaches an int64 tensor as its bit
    pattern through ``FrontierBatch.to``, ``batch_to`` and the prefetch
    producer, and unpacks as the int64 copy of the buffer does."""
    words = np.array([[0x80000001], [0xFFFFFFFF], [0x7FFFFFFF], [0xDEADBEEF]], np.uint32)
    fb = FrontierBatch(np.arange(4, dtype=np.int32), (np.arange(4, dtype=np.int32),), 4)
    fb = attach_codes(fb, words)
    want = torch.tensor(words.astype(np.int64))
    assert torch.equal(fb.to("cpu").codes, want)
    assert torch.equal(t_engine.batch_to({"frontier": fb}, "cpu")["frontier"].codes, want)

    class One:
        def next_batch(self):
            return {"frontier": fb}
    it = t_engine.PrefetchIterator(One(), depth=1, device="cpu")
    try:
        assert torch.equal(it.next_batch()["frontier"].codes, want)
    finally:
        it.close()
    assert torch.equal(codes_lib.unpack_codes(want, 256, 4),
                       codes_lib.unpack_codes(codes_lib.from_uint32(words), 256, 4))


# ---------------- the prefetch producer ----------------

def test_prefetch_resume_replays_codes_stream(graph, jhost):
    """Resuming a prefetching iterator from its ``state_dict`` replays the
    exact frontiers and code rows, which are JAX's stream's."""
    adj, labels = graph
    tr = jhost.splits["train"]

    def gather(batch):
        return dict(batch, frontier=attach_codes(batch["frontier"], jhost.codes))

    def make():
        src = t_engine.SageBatchSource(NeighborSampler(adj, (5, 5), max_deg=64, seed=0), tr,
                                       labels, BATCH, seed=0)
        return t_engine.PrefetchIterator(src, depth=2, code_gather=gather)
    it = make()
    try:
        for _ in range(3):
            it.next_batch()
        sd = it.state_dict()
        want = it.next_batch()["frontier"]
    finally:
        it.close()
    it2 = make()
    try:
        it2.load_state_dict(sd)
        got = it2.next_batch()["frontier"]
    finally:
        it2.close()
    np.testing.assert_array_equal(got.unique, want.unique)
    np.testing.assert_array_equal(got.codes, want.codes)
    jsrc = j_engine.SageBatchSource(JSampler(jhost.adj, (5, 5), max_deg=64, seed=0), tr,
                                    jhost.labels, BATCH, seed=0)
    for _ in range(3):
        jsrc.next_batch()
    np.testing.assert_array_equal(
        want.codes, np.asarray(j_attach_codes(jsrc.next_batch()["frontier"], jhost.codes).codes))


def test_prefetch_stats_account_code_stream(graph):
    """``stats()`` carries JAX's keys; each batch moves its frontier's rows
    as int64 words (8 B a word), and the uint32 count is JAX's: both are
    4 B a word of the frontiers the producer made."""
    jrt = JRuntime.from_spec(_jspec(codes_placement="host", prefetch_depth=2))
    trt = GraphRuntime.from_spec(_spec(codes_placement="host", prefetch_depth=2),
                                 graph=graph, device="cpu")
    try:
        jrt.train(3)
        trt.train(3)
        js, st = jrt.data_iter.stats(), trt.data_iter.stats()
    finally:
        jrt.close()
        trt.close()
    assert set(js) <= set(st)
    assert st["n_produced"] >= 3
    for k in ("sample_us", "code_gather_us", "put_us"):
        assert st[k] > 0.0, k
    replay = GraphRuntime.from_spec(_spec(), graph=graph, device="cpu").source
    words = codes_lib.n_words(16, 8)
    rows = [len(replay.next_batch()["frontier"].unique)
            for _ in range(max(st["n_produced"], js["n_produced"]))]
    assert st["uint32_code_bytes"] == 4 * words * sum(rows[:st["n_produced"]])
    assert js["transferred_code_bytes"] == 4 * words * sum(rows[:js["n_produced"]])
    assert st["transferred_code_bytes"] == 2 * st["uint32_code_bytes"]
    assert st["transferred_code_bytes_per_batch"] == (st["transferred_code_bytes"]
                                                      / st["n_produced"])


# ---------------- host placement is device placement, bit for bit ----------------

VARIANTS = {"plain": {},
            "cached_staleness0": dict(cache_capacity=256, cache_staleness=0),
            "planned": dict(cache_capacity=256, cache_staleness=2, cache_plan_misses=True)}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("depth", [0, 2])
def test_train_evaluate_embed_host_equals_device(graph, depth, variant):
    """Three steps (the producer, or the loop at depth 0, gathers the
    rows; the planned run gathers after the miss-first permutation), then
    ``evaluate`` and ``embed``: bitwise the device placement's."""
    dev, host = _pair(graph, prefetch_depth=depth, **VARIANTS[variant])
    try:
        assert dev.train(3).losses == host.train(3).losses
        assert _same_params(dev.params, host.params)
        if "cache" in dev.state:
            assert torch.equal(dev.state["cache"].values, host.state["cache"].values)
        assert dev.evaluate("val") == host.evaluate("val")
        ids = np.arange(0, N, 97, dtype=np.int32)
        np.testing.assert_array_equal(dev.embed(ids), host.embed(ids))
    finally:
        dev.close()
        host.close()


@pytest.mark.parametrize("route", ["cached", "uncached", "batched"])
def test_serving_host_equals_device(graph, route):
    """``serve_many`` of 4 requests and single ``serve`` calls through the
    cached engine (codes attached after the miss-first plan), the uncached
    one and the batching tier: the device placement's outputs bit for bit."""
    dev, host = _pair(graph)
    rng = np.random.default_rng(7)
    reqs = [rng.integers(0, N, int(rng.integers(4, 32))).astype(np.int32) for _ in range(4)]
    try:
        if route == "batched":
            spec = BatchingSpec(max_batch=4)
            with dev.serve(batching=spec) as td, host.serve(batching=spec) as th:
                got = [(td.serve(r), th.serve(r)) for r in reqs + reqs]
        else:
            kw = dict(serve_batch=64, max_coalesce=4)
            if route == "uncached":
                kw["cache_capacity"] = 0
            ed, eh = dev.serve(**kw), host.serve(**kw)
            got = list(zip(ed.serve_many(reqs), eh.serve_many(reqs)))
            got += [(ed.serve(r), eh.serve(r)) for r in reqs]
            assert eh.planned_frontier(reqs[:1]).codes is not None
            if route == "cached":
                assert eh.stats()["hits"] == ed.stats()["hits"] > 0
        for a, b in got:
            np.testing.assert_array_equal(a.embeddings, b.embeddings)
            np.testing.assert_array_equal(a.logits, b.logits)
            assert a.rows_decoded == b.rows_decoded
    finally:
        dev.close()
        host.close()


def test_hashemb_placement_is_a_no_op(graph):
    """hashemb stores no codes: under host placement nothing is gathered and
    training is the device placement's run bit for bit."""
    dev, host = _pair(graph, lookup_impl="hashemb", prefetch_depth=2)
    try:
        assert not host.codes_on_host and host.codes is None
        assert "codes_buf" not in host.params["embed"]
        assert dev.train(3).losses == host.train(3).losses
        assert host.data_iter.stats()["transferred_code_bytes"] == 0
    finally:
        dev.close()
        host.close()


# ---------------- against JAX's host-placed run ----------------

def _state_from_jax(jstate):
    def moments(tree):
        return params_from_jax(_np(tree), device="cpu")
    return {"params": moments(jstate["params"]),
            "opt": {"step": int(jstate["opt"]["step"]), "mu": moments(jstate["opt"]["mu"]),
                    "nu": moments(jstate["opt"]["nu"])},
            "step": int(jstate["step"])}


def test_host_run_matches_jax_host_run():
    """JAX's host-placed runtime and the port's, built from its spec JSON
    with its params and its code buffer: five steps, each from JAX's state,
    losses within 1e-5 and params within 1e-4; ``evaluate`` within the loss
    bound."""
    jrt = JRuntime.from_spec(_jspec(codes_placement="host"))
    trt = GraphRuntime.from_spec(
        RuntimeSpec.from_json(jrt.spec.to_json()).with_updates(lookup_impl="pallas"),
        device="cpu", params=params_from_jax(_np(jrt.params), device="cpu"), codes=jrt.codes)
    try:
        assert "codes_buf" not in trt.params["embed"]
        for k in range(5):
            trt.state = _state_from_jax(jrt.state)
            jl, tl = jrt.train(1).losses[0], trt.train(1).losses[0]
            assert abs(tl - jl) <= LOSS_TOL, (k, tl, jl)
            ref = dict(leaves_with_path(params_from_jax(_np(jrt.params), device="cpu")))
            for path, t in leaves_with_path(trt.params):
                np.testing.assert_allclose(t.numpy(), ref[path].numpy(), rtol=0,
                                           atol=PARAM_TOL, err_msg="/".join(path))
        trt.state = _state_from_jax(jrt.state)
        je, te = jrt.evaluate("val"), trt.evaluate("val")
        assert te["n"] == je["n"] and abs(te["loss"] - je["loss"]) <= LOSS_TOL
    finally:
        jrt.close()
        trt.close()


# ---------------- checkpoints and the spec ----------------

def test_ckpt_resume_keeps_host_placement_bitwise(graph, tmp_path):
    """Two host-placed steps, a checkpoint, ``GraphRuntime.resume`` from the
    directory alone and two more: the device placement's four straight
    steps bit for bit; the manifest's spec keeps the placement."""
    ref = GraphRuntime.from_spec(_spec(), graph=graph, device="cpu")
    want = ref.train(4).losses
    ref_params = ref.params
    ref.close()
    rt = GraphRuntime.from_spec(_spec(codes_placement="host", prefetch_depth=2,
                                      ckpt_dir=str(tmp_path), ckpt_every=2),
                                graph=graph, device="cpu")
    head = rt.train(2).losses
    rt.close()
    back = GraphRuntime.resume(str(tmp_path), graph=graph, device="cpu")
    try:
        assert back.codes_on_host and "codes_buf" not in back.params["embed"]
        assert back.spec.model.embedding.codes_placement == "host"
        tail = back.train(4)
        assert tail.resumed_from == 2
        assert head + tail.losses == want
        assert _same_params(back.params, ref_params)
    finally:
        back.close()


def test_spec_json_roundtrip_codes_placement():
    jspec = _jspec(codes_placement="host")
    tspec = RuntimeSpec.from_json(jspec.to_json())
    assert tspec.model.embedding.codes_placement == "host"
    assert tspec.to_dict() == jspec.to_dict()
    assert RuntimeSpec.from_json(tspec.to_json()) == tspec
    assert JSpec.from_json(tspec.to_json()) == jspec


# ---------------- loud failures ----------------

def test_unknown_placement_and_missing_codes_fail_as_jax(graph):
    """An unknown placement at init, a host lookup with no rows, a serving
    engine with no buffer, ``decode_all`` with no buffer, a full-graph
    model: ``ValueError`` (JAX's messages); ``codes=`` under device
    placement is refused."""
    from repro.core import embedding as jemb
    bad = dataclasses.replace(_spec().model.embedding_config(), codes_placement="hbm")
    with pytest.raises(ValueError, match="codes_placement") as terr:
        temb.init_embedding(torch.Generator().manual_seed(0), bad)
    with pytest.raises(ValueError, match="codes_placement") as jerr:
        jemb.init_embedding(jax.random.PRNGKey(0), _jspec(codes_placement="hbm")
                            .model.embedding_config())
    assert str(terr.value) == str(jerr.value)

    dev, host = _pair(graph)
    hcfg = host.cfg.embedding_config()
    with pytest.raises(ValueError, match="codes") as terr:
        temb.embed_lookup(host.params["embed"], torch.arange(4), hcfg)
    jcfg = _jspec(codes_placement="host").model.embedding_config()
    with pytest.raises(ValueError, match="codes") as jerr:
        jemb.embed_lookup(jemb.init_embedding(jax.random.PRNGKey(0), jcfg), np.arange(4), jcfg)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="host_codes"):
        temb.decode_all(host.params["embed"], hcfg)
    with pytest.raises(ValueError, match="host_codes"):
        host.serve(host_codes=None)
    with pytest.raises(ValueError, match="codes="):
        GraphRuntime.from_spec(_spec(), graph=graph, device="cpu", codes=host.codes)
    with pytest.raises(ValueError, match="codes shape"):
        GraphRuntime.from_spec(_spec(codes_placement="host"), graph=graph, device="cpu",
                               codes=host.codes[:10])
    full = _spec(codes_placement="host").with_updates(model=dataclasses.replace(
        _spec().model, model="gcn")).with_updates(codes_placement="host")
    with pytest.raises(ValueError, match="full-graph"):
        GraphRuntime.from_spec(full, graph=graph, device="cpu")
    dev.close()
    host.close()


# ---------------- the benchmark twin ----------------

def test_codes_offload_benchmark_smoke(capsys):
    """The torch twin of ``benchmarks/codes_offload.py`` at its smoke size
    on the CPU: its CSV rows, host code bytes 0 and flat, the device buffer
    growing with the graph, host losses bitwise the device's."""
    rows = bench.run(device="cpu", smoke=True)
    out = capsys.readouterr().out.splitlines()
    assert all(line.count(",") >= 2 for line in out if line.startswith("codes_offload/"))
    host = [r for r in rows if r["codes_placement"] == "host"]
    dev = [r for r in rows if r["codes_placement"] == "device"]
    assert [r["device_resident_code_bytes"] for r in host] == [0] * len(host)
    assert dev[1]["device_resident_code_bytes"] > dev[0]["device_resident_code_bytes"] > 0
    assert all(r["bitwise_equal_vs_device"] for r in host)
    assert all(r["transferred_code_bytes_per_batch"] > 0 for r in host)

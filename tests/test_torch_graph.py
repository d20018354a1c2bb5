"""Port parity: graph generators, CSR, neighbour sampling and serving
frontiers against the JAX package.

All of it is host-side numpy in both packages, so the same seeds must give
the same arrays bit for bit.
"""

import numpy as np
import pytest
import torch

from repro.configs.paper_gnn import paper_gnn_config as j_paper_gnn_config
from repro.graph import generate as jgen
from repro.graph.csr import CSRMatrix as JCSR
from repro.graph.sampler import FrontierBatch as JFrontierBatch
from repro.graph.sampler import NeighborSampler as JSampler
from repro.graph.sampler import _mix64 as j_mix64
from repro.graph.sampler import attach_codes as j_attach
from repro.graph.sampler import stream_key as j_stream_key
from repro.serving.gnn import GraphInferenceEngine as JEngine
from repro_torch.configs.paper_gnn import paper_gnn_config as t_paper_gnn_config
from repro_torch.graph import generate as tgen
from repro_torch.graph.csr import CSRMatrix as TCSR
from repro_torch.graph.sampler import FrontierBatch as TFrontierBatch
from repro_torch.graph.sampler import NeighborSampler as TSampler
from repro_torch.graph.sampler import _mix64 as t_mix64
from repro_torch.graph.sampler import attach_codes as t_attach
from repro_torch.graph.sampler import stream_key as t_stream_key
from repro_torch.serving.gnn import GraphInferenceEngine as TEngine


def _same_csr(a, b):
    np.testing.assert_array_equal(np.asarray(a.data), b.data)
    np.testing.assert_array_equal(np.asarray(a.indices), b.indices)
    np.testing.assert_array_equal(np.asarray(a.indptr), b.indptr)
    assert tuple(a.shape) == tuple(b.shape)


@pytest.fixture(scope="module")
def graphs():
    return (jgen.powerlaw_graph(3, 700, avg_degree=8, n_classes=5, homophily=0.8),
            tgen.powerlaw_graph(3, 700, avg_degree=8, n_classes=5, homophily=0.8))


def test_powerlaw_graph_identical(graphs):
    (ja, jl), (ta, tl) = graphs
    _same_csr(ja, ta)
    np.testing.assert_array_equal(jl, tl)


def test_sbm_graph_identical():
    ja, jl = jgen.sbm_graph(5, 400, n_classes=4, p_in=0.05, p_out=0.005)
    ta, tl = tgen.sbm_graph(5, 400, n_classes=4, p_in=0.05, p_out=0.005)
    _same_csr(ja, ta)
    np.testing.assert_array_equal(jl, tl)


def test_split_identical():
    for a, b in zip(jgen.train_val_test_split(2, 101), tgen.train_val_test_split(2, 101)):
        np.testing.assert_array_equal(a, b)


def test_csr_rows_and_padded_table(graphs):
    (ja, _), (ta, _) = graphs
    np.testing.assert_array_equal(np.asarray(ja.row_ids()), ta.row_ids())
    for max_deg in (4, 64):
        jt, jd = ja.neighbor_padded(max_deg)
        tt, td = ta.neighbor_padded(max_deg)
        np.testing.assert_array_equal(jt, tt)
        np.testing.assert_array_equal(jd, td)


def test_from_edges_and_matmat():
    src, dst = np.array([0, 1, 1, 3, 0]), np.array([1, 2, 2, 0, 3])
    ja, ta = JCSR.from_edges(src, dst, 5), TCSR.from_edges(src, dst, 5)
    _same_csr(ja, ta)
    # integer-valued operand: every summation order gives the same f32 sums
    X = np.random.default_rng(0).integers(-4, 5, (5, 3)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(ja.matmat(X)),
                                  ta.matmat(torch.from_numpy(X)).numpy())


def test_mix64_and_stream_key():
    x = np.arange(1000, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    np.testing.assert_array_equal(j_mix64(x), t_mix64(x))
    assert j_stream_key(7, 11) == t_stream_key(7, 11)


@pytest.mark.parametrize("pad_to,cap", [(16, None), (1, None), (16, 2048)])
def test_sample_frontier_bitwise(graphs, pad_to, cap):
    (ja, _), (ta, _) = graphs
    js, ts = JSampler(ja, (5, 3), max_deg=16), TSampler(ta, (5, 3), max_deg=16)
    batch = np.random.default_rng(1).choice(700, 40, replace=False).astype(np.int32)
    jl = js.sample(batch, rng=np.random.default_rng(9))
    tl = ts.sample(batch, rng=np.random.default_rng(9))
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(a, b)
    if cap is None:
        jf = js.sample_frontier(batch, pad_to=pad_to, rng=np.random.default_rng(9))
        tf = ts.sample_frontier(batch, pad_to=pad_to, rng=np.random.default_rng(9))
    else:
        jf = JFrontierBatch.from_levels(jl, pad_to=pad_to, cap=cap)
        tf = TFrontierBatch.from_levels(tl, pad_to=pad_to, cap=cap)
    np.testing.assert_array_equal(np.asarray(jf.unique), tf.unique)
    assert int(jf.n_unique) == tf.n_unique
    for a, b in zip(jf.index_maps, tf.index_maps):
        np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(tf.levels(), tl):
        np.testing.assert_array_equal(a, b)
    dev = tf.to("cpu")
    assert dev.unique.dtype == torch.int64
    np.testing.assert_array_equal(dev.unique.numpy(), tf.unique)


def test_frontier_cap_overflow_raises(graphs):
    (_, _), (ta, _) = graphs
    levels = TSampler(ta, (5, 3)).sample(np.arange(40, dtype=np.int32),
                                         rng=np.random.default_rng(0))
    with pytest.raises(ValueError, match="cap"):
        TFrontierBatch.from_levels(levels, cap=8)


def test_request_frontier_matches_jax_engine(graphs):
    (ja, _), (ta, _) = graphs
    jcfg = j_paper_gnn_config("sage", n_nodes=700, n_classes=5, fanout=4)
    tcfg = t_paper_gnn_config("sage", n_nodes=700, n_classes=5, fanout=4)
    kw = dict(serve_batch=24, pad_to=32, cache_capacity=0, seed=5)
    je = JEngine(jcfg, None, JSampler(ja, jcfg.fanouts), interpret=True, **kw)
    te = TEngine(tcfg, None, TSampler(ta, tcfg.fanouts), device="cpu", **kw)
    assert je.frontier_cap == te.frontier_cap
    for ids in (np.arange(24), np.array([3, 9, 600, 3]), np.arange(100, 110)):
        jf, tf = je.frontier_for(ids), te.frontier_for(ids)
        np.testing.assert_array_equal(np.asarray(jf.unique), tf.unique)
        assert int(jf.n_unique) == tf.n_unique
        for a, b in zip(jf.index_maps, tf.index_maps):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_attach_codes_matches_jax(graphs):
    (ja, _), (ta, _) = graphs
    host = np.random.default_rng(2).integers(0, 2**32, (700, 3), dtype=np.uint64).astype(np.uint32)
    batch = np.arange(0, 700, 29, dtype=np.int32)
    jf = j_attach(JSampler(ja, (4, 2)).sample_frontier(
        batch, pad_to=8, rng=np.random.default_rng(1)), host)
    tf = t_attach(TSampler(ta, (4, 2)).sample_frontier(
        batch, pad_to=8, rng=np.random.default_rng(1)), host)
    np.testing.assert_array_equal(np.asarray(jf.codes), tf.codes)
    assert t_attach(tf, host) is tf                       # idempotent
    np.testing.assert_array_equal(tf.to("cpu").codes.numpy(), tf.codes.astype(np.int64))

"""The port's own full-graph learning runs (moved whole, bounds unchanged,
from ``tests/test_torch_fullgraph.py``, whose worker they held longest):
GCN, SGC and GIN through ``GraphRuntime``'s front door and GCN's link
prediction, on the 2,000-node power-law graph of that file (identical in
both packages), the paper's models narrowed as ``tests/test_gnn.py``
narrows them (c=16, m=8, d_c=d_m=64).  Held to ``tests/test_gnn.py``'s
thresholds: accuracy above 0.25 (chance 0.125), hits@50 above 0.1.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.graph.generate import powerlaw_graph as j_powerlaw
from repro_torch.configs.paper_gnn import paper_gnn_config
from repro_torch.graph import engine as t_engine
from repro_torch.graph.generate import holdout_edges, powerlaw_graph
from repro_torch.graph.runtime import GraphRuntime, GraphSource, RuntimeSpec
from repro_torch.models import gnn as tgnn
from repro_torch.nn.module import value_and_grad
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

N, N_CLASSES = 2000, 8
MODELS = ("gcn", "sgc", "gin")


def _narrow(cfg, **emb):
    return dataclasses.replace(cfg, embedding=dataclasses.replace(
        cfg.embedding, c=16, m=8, d_c=64, d_m=64, **emb))


@pytest.fixture(scope="module")
def graph():
    jadj, jlabels = j_powerlaw(0, N, avg_degree=8, n_classes=N_CLASSES, homophily=0.9)
    tadj, tlabels = powerlaw_graph(0, N, avg_degree=8, n_classes=N_CLASSES, homophily=0.9)
    np.testing.assert_array_equal(tlabels, jlabels)
    return jadj, tadj, tlabels


# ---------------- the port's own learning runs ----------------

def _learning_spec(model, **kw):
    cfg = _narrow(paper_gnn_config(model, n_nodes=N, n_classes=N_CLASSES), **kw)
    return RuntimeSpec(graph=GraphSource(n_nodes=N, n_classes=N_CLASSES, avg_degree=8,
                                         homophily=0.9), model=cfg)


@pytest.mark.parametrize("model", MODELS)
def test_fullgraph_models_learn(model):
    """``tests/test_gnn.py::test_fullgraph_models_learn`` through the
    port's front door: 50 steps at lr 1e-2, test accuracy above 0.25."""
    rt = GraphRuntime.from_spec(_learning_spec(model), device="cpu")
    res = rt.train(50)
    assert np.isfinite(res.losses).all()
    acc = rt.evaluate("test")["accuracy"]
    assert acc > 0.25, f"{model}: acc {acc} not above chance (0.125)"


def test_link_prediction_learns(graph):
    """``tests/test_gnn.py::test_link_prediction_learns`` with the port's
    modules: GCN with ``task="link"``, 30 steps of 512 positive and 512
    uniform negative pairs, hits@50 above 0.1."""
    _, adj, _ = graph
    cfg = dataclasses.replace(_narrow(paper_gnn_config("gcn", n_nodes=N,
                                                       n_classes=N_CLASSES)), task="link")
    gen = torch.Generator().manual_seed(0)
    model = t_engine.GNNModel(cfg, "cpu")
    from repro_torch.core import embedding as emb_lib
    params = model.init(gen, codes=emb_lib.make_codes(gen, cfg.embedding_config(), aux=adj))
    train_adj, pos_eval = holdout_edges(0, adj, 0.15)
    full = t_engine.FullGraphBatch(train_adj.with_self_loops().normalized("sym").on("cpu"))
    rid, cid = train_adj.row_ids(), train_adj.indices
    rng = np.random.default_rng(0)
    opt, ocfg = adamw_init(params), AdamWConfig(lr=1e-2, weight_decay=0.0)
    for _ in range(30):
        sel = rng.integers(0, rid.shape[0], 512)
        pos = torch.from_numpy(np.stack([rid[sel], cid[sel]], 1))
        neg = torch.from_numpy(rng.integers(0, N, (512, 2)))
        _, grads = value_and_grad(lambda p: tgnn.link_loss(model.apply(p, full), pos, neg),
                                  params)
        adamw_update(params, grads, opt, ocfg)
    with torch.no_grad():
        h = model.apply(params, full)
    neg_eval = rng.integers(0, N, pos_eval.shape)
    hits = tgnn.hits_at_k(tgnn.link_scores(h, pos_eval), tgnn.link_scores(h, neg_eval), 50)
    assert hits > 0.1

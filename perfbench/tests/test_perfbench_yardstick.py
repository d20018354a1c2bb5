"""The yardstick's arithmetic against hand counts: the graph generator,
the roofline and MFU readers, the stage readers and the trace reader."""

import importlib.util
import sys

import numpy as np
import pytest

from perfbench import devtrace, graphgen, harness, inputs

METRICS = harness.HERE / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(f"perfbench_yardstick_{name}",
                                                  METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_generator_is_deterministic_with_exact_counts():
    a = graphgen.powerlaw_edges(2**40 + 3, 3000, 20000, 7, 0.65, 2.5)
    b = graphgen.powerlaw_edges(2**40 + 3, 3000, 20000, 7, 0.65, 2.5)
    c = graphgen.powerlaw_edges(2**40 + 4, 3000, 20000, 7, 0.65, 2.5)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    src, dst, labels = a
    assert src.shape == dst.shape == (20000,)
    assert np.all(src < dst) and dst.max() < 3000
    assert np.unique(src * 3000 + dst).shape[0] == 20000
    assert labels.shape == (3000,) and labels.min() >= 0 and labels.max() < 7
    assert np.unique(c[0] * 3000 + c[1]).shape[0] == 20000
    assert not np.array_equal(np.sort(src * 3000 + dst), np.sort(c[0] * 3000 + c[1]))
    same = np.mean(labels[src] == labels[dst])
    assert 0.55 < same < 0.75


def test_relabelling_keeps_the_work_and_changes_the_inputs():
    src, dst, labels = graphgen.powerlaw_edges(7, 2000, 9000, 5, 0.65, 2.5)
    a = graphgen.relabelled(src, dst, labels, 2**40 + 1)
    b = graphgen.relabelled(src, dst, labels, 2**40 + 1)
    c = graphgen.relabelled(src, dst, labels, 2**40 + 2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)

    def degrees(g):
        return np.sort(np.bincount(np.concatenate(g[:2]), minlength=2000))

    for g in (a, c):
        assert np.all(g[0] < g[1]) and np.unique(g[0] * 2000 + g[1]).shape[0] == 9000
        np.testing.assert_array_equal(degrees(g), degrees((src, dst)))
        np.testing.assert_array_equal(np.bincount(g[2]), np.bincount(labels))
        assert np.mean(g[2][g[0]] == g[2][g[1]]) == np.mean(labels[src] == labels[dst])
    assert not np.array_equal(a[0], c[0])


def test_derived_seeds_take_any_whole_number():
    assert inputs.derived_seeds(5, 3) == inputs.derived_seeds(5, 3)
    assert inputs.derived_seeds(5, 3) != inputs.derived_seeds(6, 3)
    for s in inputs.derived_seeds(-(2**40), 4) + inputs.derived_seeds(2**33 + 1, 4):
        assert 0 <= s < 2**63


def test_draw_gives_the_same_weights_from_the_same_seed():
    specs = [("a", (3, 4), 0.5), ("b", (4,), 0.0), ("c", (2, 2), 2.0)]
    w = inputs.draw(specs, 11, "cpu")
    again = inputs.draw(specs, 11, "cpu")
    assert all(np.array_equal(w[k].numpy(), again[k].numpy()) for k in w)
    assert w["b"].abs().sum() == 0 and w["a"].shape == (3, 4)


def test_hash_decode_work_by_hand():
    r = reader("hash_decode_roofline")
    # 10 rows, m 2, c 4, d_c 3: codes 10*2*4 B, 5 named rows * 3 * 4 B, rows 10*3*4 B
    assert r.call_bytes(10, 2, 4, 3, 4, 5) == 80 + 60 + 120
    assert r.call_adds(10, 2, 3) == 10 * 1 * 3
    full = dict(rows=169_343, m=16, c=256, d_c=512, elem=4, named=4096)
    # the decode at full graph is bound by its bytes: 366 MB at 3.35 TB/s
    assert r.bound_s(full) == pytest.approx(
        (169_343 * 64 + 4096 * 2048 + 169_343 * 2048) / 3.35e12)


def test_codebook_gradient_work_by_hand():
    r = reader("hash_decode_bwd_roofline")
    assert r.call_bytes(10, 2, 4, 3, 4) == 10 * 3 * 4 + 10 * 2 * 4 + 2 * 4 * 3 * 4
    assert r.call_adds(10, 2, 3) == 60


class FakeTrace:
    def __init__(self, seconds, launches):
        self.seconds, self.launches = seconds, launches

    def kernel_time(self, pattern):
        return self.seconds, self.launches


def test_roofline_reader_divides_the_bound_by_the_kernel_time():
    r = reader("hash_decode_roofline")
    call = dict(rows=1000, m=16, c=256, d_c=512, elem=4, named=100)
    ctx = {"work": {"hash_decode": [call]},
           "profile": {"units": 4, "trace": FakeTrace(4 * 2 * r.bound_s(call), 4)}}
    assert r.read(ctx) == pytest.approx(50.0)
    ctx["profile"]["trace"] = FakeTrace(0.0, 0)
    assert r.read(ctx) is None
    assert r.read({"work": {}, "profile": ctx["profile"]}) is None


def tiny_gcn(n_gnn_layers=2):
    return {"system": "fullgraph_gnn", "n_nodes": 10, "n_edges": 20, "n_classes": 3,
            "d_e": 4, "hidden": 5, "n_gnn_layers": n_gnn_layers, "compute_dtype": "float32",
            "split_frac": [0.7, 0.1, 0.2],
            "embedding": {"c": 4, "m": 2, "d_c": 6, "d_m": 6, "n_layers": 3}}


@pytest.mark.parametrize("n_gnn_layers", [2, 3])
def test_gcn_flops_by_hand(n_gnn_layers):
    r = reader("step_mfu")
    cfg = tiny_gcn(n_gnn_layers)
    nnz = 2 * 20 + 10                                     # both directions and self loops
    decoder = 10 * (6 * 6 + 6 * 6 + 6 * 4)
    # GCN layers 4 -> 5, then 5 -> 5 for each further layer; 7 training rows 5 -> 3
    layers = 10 * (4 * 5 + 5 * 5 * (n_gnn_layers - 1))
    dense = decoder + layers + 7 * 5 * 3
    sparse = nnz * (4 + 5 * (n_gnn_layers - 1))           # each layer aggregates its input
    forward = 2 * dense + 2 * sparse + 10 * 1 * 6         # decode: m - 1 adds of d_c
    backward = 4 * dense + 2 * sparse + 10 * 2 * 6        # the codebook gradient: m adds
    assert r.gcn_flops(cfg, {"mode": "train"}) == forward + backward
    ctx = {"config": cfg, "traffic": {"mode": "train"},
           "plain": {"units": 3, "seconds": 2.0}}
    want = 100 * 3 * r.gcn_flops(cfg, {"mode": "train"}) / (2.0 * 67e12)
    assert r.read(ctx) == pytest.approx(want)


def tiny_lm():
    return {"system": "lm_train", "num_hidden_layers": 2, "hidden_size": 8,
            "intermediate_size": 4, "num_attention_heads": 2, "num_key_value_heads": 1,
            "num_local_experts": 4, "num_experts_per_tok": 2, "vocab_padded": 16,
            "compute_dtype": "bfloat16",
            "embedding": {"c": 4, "m": 2, "d_c": 6, "d_m": 6, "n_layers": 2}}


def test_lm_flops_by_hand():
    r = reader("step_mfu")
    cfg, traffic = tiny_lm(), {"batch": 2, "seq": 4}
    # a layer: q 8 x 8, k and v 8 x 4 each (one KV head of 4), o 8 x 8
    attn = 64 + 32 + 32 + 64
    # the 2 routed experts' gate, up and down (8 x 4 each), and the router
    # over the 4 real experts; the dense dispatch's other experts not counted
    experts = 2 * 3 * 32 + 8 * 4
    head = 8 * 16
    decoder = 6 * 6 + 6 * 8                                # the embedding's MLP, 6 -> 6 -> 8
    tokens = 2 * 4
    # QK^T and PV, 2 S^2 Dh each, forward and backward (x3), over 2 layers, 2 heads
    # and a batch of 2, the causal half
    attention = 3 * (2 * 2 * 16 * 4) * 2 * 2 * 2 / 2
    want = 6 * (2 * (attn + experts) + head + decoder) * tokens + attention
    assert r.lm_flops(cfg, traffic) == want == 53184
    ctx = {"config": cfg, "traffic": traffic, "plain": {"units": 5, "seconds": 0.5}}
    assert r.read(ctx) == pytest.approx(100 * 5 * want / (0.5 * 989e12))


def test_flash_attention_work_by_hand():
    r = reader("flash_attention_roofline")
    # QK^T and PV, 2 S^2 Dh each a head: 2 * 2 * 16 * 4 * 2 heads * 2 batch
    assert r.call_flops(2, 4, 2, 4, causal=False) == 1024
    assert r.call_flops(2, 4, 2, 4, causal=True) == 512
    # q and o: 2 x 4 rows of 2 heads of 4 bf16 (128 B each); k and v: 1 head (64 B each)
    assert r.call_bytes(2, 4, 2, 1, 4, 2) == 128 + 64 + 64 + 128
    granite = dict(batch=4, seq=2048, heads=24, kv_heads=8, head_dim=64, elem=2, causal=True)
    flops = 4 * 4 * 24 * 2048**2 * 64 / 2
    bytes_ = 4 * 2048 * (48 + 16) * 64 * 2
    assert flops / 989e12 > bytes_ / 3.35e12             # bound by the tensor cores
    assert r.bound_s(granite) == pytest.approx(flops / 989e12)
    f32 = dict(granite, elem=4)
    assert r.bound_s(f32) == pytest.approx(flops / 67e12)


def test_stage_and_idle_readers():
    ctx = {"stages": {"units": 4, "ms": {"mlp": [1.0, 2.0, 3.0, 4.0], "spmm": [1.0] * 8}},
           "profile": {"seconds": 2.0, "busy_s": 1.5}}
    assert reader("decoder_mlp_ms").read(ctx) == pytest.approx(2.5)
    assert reader("spmm_ms").read(ctx) == pytest.approx(2.0)
    assert reader("optimizer_ms").read(ctx) is None
    assert reader("idle_pct").read(ctx) == pytest.approx(25.0)


def test_trace_reader_merges_and_attributes():
    ev = [
        {"ph": "X", "cat": "kernel", "name": "void hash_decode_staged<float>(int)", "ts": 0,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "void hash_decode_count_kernel(int)", "ts": 5,
         "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 30, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "sgemm", "ts": 50, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 14, "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "aten::argmax", "ts": 36, "dur": 12},
    ]
    t = devtrace.DeviceTrace(ev)
    assert np.allclose(t.busy_intervals(), [(0.0, 15e-6), (30e-6, 35e-6), (50e-6, 60e-6)])
    assert t.busy_s() == pytest.approx(30e-6)
    assert t.kernel_time(r"\bhash_decode_(staged|kernel)\b") == (pytest.approx(10e-6), 1)
    assert t.kernel_time(r"\bhash_decode_(count|place|sum)_kernel\b")[1] == 1
    gaps = dict((n, s) for n, s in t.idle_gaps())
    assert gaps == {"aten::item": pytest.approx(15e-6), "aten::argmax": pytest.approx(15e-6)}
    assert t.device_ops()[0][0] in ("void hash_decode_staged<float>(int)",
                                    "void hash_decode_count_kernel(int)", "sgemm")


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro_torch.fake_for_test", object())
    monkeypatch.setitem(sys.modules, "reproduce", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert set(harness.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "repro.fake_for_test", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert set(harness.forbidden_modules()) == before | {"repro", "jax"}


def test_the_harness_loads_no_forbidden_module():
    import subprocess
    code = ("import sys; import perfbench.harness, perfbench.probe, perfbench.faults, "
            "perfbench.systems.fullgraph_gnn, perfbench.reference.fullgraph_gnn; "
            "import repro_torch.graph.runtime, repro_torch.stages, repro_torch.train.loop; "
            "[perfbench.harness.metric_reader(p.stem) for p in perfbench.harness.HERE.joinpath("
            "'metrics').glob('[a-z]*.py')]; "
            "print(perfbench.harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(harness.ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"

"""``correct`` on the CPU at a size a test run holds: a sound run passes
its cell's limits, the control (the reference in the precision below the
configuration's, in the program's place) does not, and neither does a
run of the harness with each fault its cell can have planted underneath
(``perfbench.faults``).  The cells' limits are the ones the card's
readings set.  Also the comparison's own arithmetic."""

import copy
import io
import json

import pytest

from perfbench import faults, harness, manifest

GCN_SMALL = {"n_nodes": 600, "n_edges": 2400, "n_classes": 5, "d_e": 16, "hidden": 16}
GCN_EMBEDDING = {"c": 16, "m": 8, "d_c": 32, "d_m": 32}
# float32: bfloat16's rounding over 64 tokens a step reads above the
# limits that the card's readings set at 8,192 tokens a step
LM_SMALL = {"num_hidden_layers": 2, "hidden_size": 96, "num_attention_heads": 6,
            "num_key_value_heads": 2, "intermediate_size": 32, "num_local_experts": 8,
            "num_experts_per_tok": 2, "vocab_size": 300, "vocab_padded": 512,
            "n_experts_padded": 16, "compute_dtype": "float32"}
LM_EMBEDDING = {"c": 16, "m": 8, "d_c": 32, "d_m": 32}
LM_TRAFFIC = {"mode": "train", "batch": 2, "seq": 32, "checked_steps": 3, "cooc_batches": 2,
              "stream": {"n_topics": 8, "zipf_a": 1.2, "topic_stickiness": 0.9}}
SEED = 2**35 + 11


def small(cell_name):
    """(config, traffic) of a cell at the test's size: every width cut,
    the structure kept.  The decode goes through the kernel's wrapper, as
    ``auto`` sends it on the card; its plain version runs here."""
    m = manifest.load()
    _cell, config, traffic, _limits = harness.cell_files(m, cell_name)
    config = copy.deepcopy(config)
    config["embedding"]["lookup_impl"] = "pallas"
    if config["system"] == "fullgraph_gnn":
        config.update(GCN_SMALL)
        config["embedding"].update(GCN_EMBEDDING)
        return config, traffic
    config.update(LM_SMALL)
    config["embedding"].update(LM_EMBEDDING)
    return config, LM_TRAFFIC


def cells():
    return [w["name"] for w in manifest.load()["workloads"]]


def run(cell_name, on_system=None):
    config, traffic = small(cell_name)
    out, err = io.StringIO(), io.StringIO()
    # the test process may hold JAX for other tests: the benchmark's own
    # look for it runs in run.py's process, and test_perfbench_yardstick
    # holds it
    line = harness.run(cell_name, SEED, 0.2, False, device="cpu", config=config,
                       traffic=traffic, on_system=on_system, check_modules=False,
                       out=out, err=err)
    assert line is not None and json.loads(out.getvalue().splitlines()[-1]) == line
    return line, err.getvalue()


@pytest.mark.parametrize("cell_name", cells())
def test_a_sound_run_is_correct(cell_name):
    line, err = run(cell_name)
    assert line["correct"], err
    assert line["attempted"] > 0 and line["failed"] == 0
    m = manifest.load()
    assert set(line["metrics"]) == {x["name"] for x in manifest.metrics_of(m, cell_name,
                                                                            "end_to_end")}
    last = err.strip().splitlines()[-len(line["checks"]):]
    assert all(s.startswith("[check] ") and " limit " in s for s in last)
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell_name", cells())
def test_the_control_is_not_correct(cell_name):
    config, traffic = small(cell_name)
    limits = harness.cell_files(manifest.load(), cell_name)[3]
    system = harness.build_system(config, traffic, SEED + 1, "cpu")
    system.setup()
    system.release()
    numbers = system.compare(system.reference(), got=system.control())
    assert any(numbers[k] > limit for k, limit in limits.items()), numbers


def fault_cases():
    out = []
    for cell_name in cells():
        config, traffic = small(cell_name)
        system = harness.build_system(config, traffic, SEED, "cpu")
        out += [(cell_name, f) for f in system.faults()]
    return out


@pytest.mark.parametrize("cell_name, fault", fault_cases())
def test_a_fault_underneath_is_not_correct(cell_name, fault):
    undo = []
    try:
        line, err = run(cell_name, on_system=lambda s: undo.append(faults.plant(s, fault)))
    finally:
        for u in undo:
            u()
    assert not line["correct"], err


def test_compare_takes_the_worst_step_and_the_worst_leaf():
    from perfbench.compare import codes_gap, compare_train
    import torch
    want = {"losses": [2.0, 1.0, 0.5],
            "grad_norms": {"a": 1.0, "b": 2.0, "c": 4.0, "d": 1e-6},
            "delta_norms": {"a": 1.0, "b": 1.0, "c": 1.0, "d": 1e-3}}
    got = {"losses": [2.0, 1.01, 0.5],
           "grad_norms": {"a": 1.0, "b": 2.5, "c": 4.0, "d": 0.0},
           "delta_norms": {"a": 1.0, "b": 1.0, "c": 1.3, "d": 5.0}}
    n = compare_train(got, want)
    assert n["loss_gap"] == pytest.approx(0.01)            # the second step's
    assert n["grad_gap"] == pytest.approx(0.25)            # b: 0.5 over its own 2
    # d's reference gradient is under a thousandth of the median's: left out
    assert "update_gap.d" not in n
    assert n["update_gap"] == pytest.approx(0.3) == n["update_gap.c"]
    assert n["update_gap_median"] == 0.0
    a = torch.tensor([[1, 2], [3, 4]])
    assert codes_gap(a, a.clone()) == 0.0
    assert codes_gap(a, torch.tensor([[1, 2], [3, 5]])) == 1.0

"""The benchmark's manifest: the schema the driver holds it to, and every
file the harness finds by a name in it."""

import importlib.util
import json

import pytest

from perfbench import manifest

ROOT = manifest.ROOT
HERE = ROOT / "perfbench"


@pytest.fixture(scope="module")
def m():
    return manifest.load()


def test_manifest_meets_the_schema(m):
    assert manifest.validate(m) == []


def test_configs_have_exactly_the_five_keys(m):
    for c in m["configs"]:
        assert set(c) == {"file", "name", "reduced", "source", "why"}
        assert len(c["source"]) <= 200


@pytest.mark.parametrize("bad, fragment", [
    ({"configs": [{"name": "x", "file": "perfbench/configs/gcn-arxiv.json", "reduced": [],
                   "source": "s"}]}, "keys"),
    ({"end_to_end": [{"name": "setup s", "unit": "s", "better": "lower", "bound": 0.25,
                      "source": "host_clock"}]}, "bad name"),
    ({"end_to_end": [{"name": "setup_s", "unit": "seconds per run", "better": "lower",
                      "bound": 0.25, "source": "host_clock"}]}, "bad unit"),
    ({"command": ["python3", "src/repro_torch/run.py"]}, "outside paths"),
    ({"run_seconds": 60}, "run_seconds"),
])
def test_schema_refuses_what_the_driver_refuses(m, bad, fragment):
    broken = dict(m, **bad)
    assert any(fragment in e for e in manifest.validate(broken))


def test_a_metric_must_be_reported_where_it_moves(m):
    broken = json.loads(json.dumps(m))
    step = next(x for x in broken["end_to_end"] if x["name"] == "step_ms")
    step["workloads"] = [broken["workloads"][0]["name"]]
    errors = manifest.validate(broken)
    assert any("which the cell does not report" in e for e in errors)


def test_every_cell_finds_its_files(m):
    for cell in m["workloads"]:
        config = json.loads((ROOT / manifest.config_entry(m, cell["config"])["file"]).read_text())
        assert config["name"] == cell["config"]
        assert (HERE / "systems" / f"{config['system']}.py").is_file()
        assert (HERE / "reference" / f"{config['system']}.py").is_file()
        assert (HERE / "traffic" / f"{cell['traffic']}.json").is_file()
        limits = json.loads((HERE / "limits" / f"{cell['name']}.json").read_text())
        assert limits and all(isinstance(v, (int, float)) for v in limits.values())


def test_every_per_layer_metric_has_a_reader(m):
    for x in m["per_layer"]:
        path = HERE / "metrics" / f"{x['name']}.py"
        spec = importlib.util.spec_from_file_location(f"perfbench_reader_{x['name']}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        assert callable(module.read)
        assert x["moves"] == "step_ms"


def test_rooflines_and_mfu_are_named_by_the_contract(m):
    for x in m["per_layer"]:
        if x["name"].endswith("_roofline") or "mfu" in x["name"]:
            assert x["unit"] == "%" and x["better"] == "higher"

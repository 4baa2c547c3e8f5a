"""Every file of the benchmark parses and names what exists: configurations,
mixes, cells, entry loops and metric readers, and BENCHMARK.json agrees with
the cells' files."""
import json
import re

import pytest

from perfbench.harness import specs

BENCH = specs.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"] and BENCH["paths"] == ["perfbench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_parse(cell):
    w = specs.workload(cell)
    entry = next(x for x in BENCH["workloads"] if x["name"] == cell)
    assert (w["config"], w["traffic"], w["chips"], w["why"]) == (entry["config"], entry["traffic"], entry["chips"],
                                                                entry["why"])
    assert w["config_spec"]["name"] == w["config"]
    assert all(hasattr(specs.entry(w["entry"]), f) for f in ("setup", "window", "free", "numbers"))
    for name, c in w["compare"].items():
        assert c["limit"] >= 0.0, name


@pytest.mark.parametrize("cell", CELLS)
def test_per_layer_metrics_move_a_metric_the_cell_reports(cell):
    w = specs.workload(cell)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    reported = set(w["end_to_end"]) | {"setup_s"}
    for name in w["end_to_end"]:
        assert cell in e2e[name].get("workloads", [cell])
    layer = {m["name"]: m for m in BENCH["per_layer"]}
    for name in w["per_layer"]:
        m = layer[name]
        assert m["moves"] in reported and cell in m["workloads"]
        assert hasattr(specs.metric_reader(name), "read")
    listed = {m["name"] for m in BENCH["per_layer"] if cell in m.get("workloads", [])}
    assert listed == set(w["per_layer"])


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_configuration_files(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    spec = specs.config(config)
    assert entry["file"] == f"perfbench/configs/{config}.json"
    assert entry["source"] == spec["source"] and entry["reduced"] == spec["reduced"]
    assert spec["precision"]["control"] in ("fp8", "tf32")
    widths = re.compile(r"(_DIM|_RANK|HIDDEN|INTERMEDIATE|CHANNELS)$")
    assert not any(widths.search(k) for k in spec["reduced"])

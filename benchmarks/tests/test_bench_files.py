"""Every cell, configuration, traffic mix, driver and metric of
BENCHMARK.json is found by name under benchmarks/, and the file keeps to
the benchmark's contract on keys and names."""
import json
import re

import pytest

import tiny
import harness

BM = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_sizes():
    assert set(BM) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                       "per_layer"}
    assert BM["paths"] == ["benchmarks"] and BM["command"][1] == "benchmarks/run.py"
    assert 1 <= BM["run_seconds"] <= 51
    assert len(json.dumps(BM)) < 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BM[k]]
    assert all(NAME.match(n) for n in names)
    assert len({x["name"] for x in BM["workloads"]}) == len(BM["workloads"])
    metrics = [m["name"] for m in BM["end_to_end"] + BM["per_layer"]]
    assert len(set(metrics)) == len(metrics)


@pytest.mark.parametrize("cfg", BM["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    data = harness.load_json(harness.ROOT / cfg["file"])
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    assert hasattr(harness.load_module("configs", cfg["name"]), "Program")


@pytest.mark.parametrize("wl", BM["workloads"], ids=lambda w: w["name"])
def test_cells_found_by_name(wl):
    assert set(wl) == {"name", "config", "traffic", "chips", "why"}
    cell = harness.load_cell(wl["name"])
    assert cell.workload["config"] == wl["config"] and cell.workload["traffic"] == wl["traffic"]
    assert cell.workload["chips"] == wl["chips"] == 1
    for fn in ("warm_up", "window", "traced"):
        assert callable(getattr(cell.driver, fn))
    assert set(cell.workload["limits"])
    co, mo = tiny.overrides(wl["name"])              # the CPU tests' sizes, found by name
    assert set(co) <= set(cell.config) and set(mo) <= set(cell.mix)
    listed = harness.listed_metrics(wl["name"], BM)
    assert "setup_s" in [m["name"] for m in listed["end_to_end"]]
    assert len(listed["end_to_end"]) >= 2 and listed["per_layer"]


@pytest.mark.parametrize("m", BM["end_to_end"] + BM["per_layer"], ids=lambda m: m["name"])
def test_metric_readers(m):
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert callable(harness.load_module("metrics", m["name"]).read)
    if m in BM["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] in [e["name"] for e in BM["end_to_end"]]
        cells = [w["name"] for w in BM["workloads"]]
        assert set(m["workloads"]) <= set(cells)
        moved = next(e for e in BM["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))

"""BENCHMARK.json against the files the harness finds by name, and the
contract's limits on names, units and keys."""

import json
import re

import pytest

from benchmark.harness import HERE, ROOT, load_spec, reports

SPEC = load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_exist(cell):
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    cfg = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert (ROOT / cfg["file"]).is_file()
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    assert (HERE / "runners" / f"{traffic["runner"]}.py").is_file()
    limits = json.loads((HERE / "limits" / f"{cell}.json").read_text())
    assert limits and all(v > 0 for v in limits.values())
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = [m["name"] for m in SPEC["end_to_end"] if reports(m, cell, SPEC)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = [m for m in SPEC["per_layer"] if reports(m, cell, SPEC)]
    assert layers and all(m["moves"] in e2e for m in layers)


def test_names_units_and_metric_files():
    names = [c["name"] for c in SPEC["configs"]] + CELLS
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in [e["name"] for e in SPEC["end_to_end"]]
    assert sum(1 for m in SPEC["end_to_end"] if m["name"] == "setup_s") == 1


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_config_files_hold_what_is_run(config):
    entry = next(c for c in SPEC["configs"] if c["name"] == config)
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["reduced"] == entry["reduced"]
    assert data["source"] == entry["source"]
    assert any(w["config"] == config for w in SPEC["workloads"])

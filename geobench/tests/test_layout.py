"""BENCHMARK.json and the files it names: every cell, configuration, traffic
mix, loop kind and per-layer metric is found by its name, and every name
and unit keeps to the characters the contract allows."""

import json
import re
from pathlib import Path

import pytest

from geobench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["geobench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    entry = {w["name"]: w for w in BENCH["workloads"]}[cell]
    c = harness.load_cell(cell)
    assert c["config"]["name"] == entry["config"]
    assert c["traffic"]["name"] == entry["traffic"]
    assert (ROOT / "geobench" / "drivers" / f"{c['driver']}.py").is_file()
    assert c["precision"] in ("int8", "bf16")
    assert c["limits"] and set(c["limits"]) <= {
        "max_gap", "mean_gap", "loss_gap", "grad_gap_median",
        "change_gap_median"}
    e2e, per_layer = harness.cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per_layer
    assert all(m["moves"] in names for m in per_layer)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(config):
    assert config["file"] == f"geobench/configs/{config['name']}.json"
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["reduced"] == config["reduced"]
    assert sum(data["stage_sizes"]) > 0 and data["feature_dim"] == 2048
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    reader = harness.load_module("metrics", metric["name"])
    assert reader.LAYER == metric["layer"]
    assert reader.SOURCE == metric["source"]
    assert set(metric["workloads"]) <= set(CELLS)
    # off the card there is no trace: a device reader reports nothing
    if metric["source"] == "device_trace":
        cell = harness.load_cell(metric["workloads"][0])
        assert reader.read({"cell": cell, "trace": None}) is None


def test_roofline_and_mfu_names():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"

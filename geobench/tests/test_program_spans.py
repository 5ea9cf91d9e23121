"""The readers of the port's spans (`source` program_span): the port
records spans only while the traced window's profiler runs, and only a CUDA
run has one, so off the card each reader reports nothing. `test_layout.py`
checks their `LAYER` and `SOURCE` against BENCHMARK.json as it checks every
reader's."""

import json
from pathlib import Path

import pytest

from geobench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = [m for m in BENCH["per_layer"] if m["source"] == "program_span"]


def test_span_metrics_exist():
    assert SPAN_METRICS


@pytest.mark.parametrize("metric", SPAN_METRICS, ids=lambda m: m["name"])
def test_program_span_reader_reads_nothing_off_the_card(metric):
    reader = harness.load_module("metrics", metric["name"])
    cell = harness.load_cell(metric["workloads"][0])
    assert reader.read({"cell": cell, "trace": None, "chips": 1}) is None

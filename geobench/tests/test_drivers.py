"""Each loop kind runs end to end on the CPU at a tiny size, answers
correctly, and reports no device metric; the command refuses to run
without a card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from geobench import harness
from geobench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("engine", ["int8", "bf16"])
def test_offline_driver(engine):
    c = tiny.cell(tiny.OFFLINE, **(tiny.INT8 if engine == "int8"
                                   else tiny.BF16))
    out = tiny.run(c)
    assert out.correct, out.compared
    assert out.attempted > 0 and out.attempted % 4 == 0 and out.failed == 0
    assert out.end_to_end["images_per_s"] > 0 and out.end_to_end["setup_s"] > 0
    assert out.trace is None and out.memory_peak_bytes == 0
    images, answers = out.sample
    assert len(images) == 4 * min(out.counters["calls"], 2)
    assert set(answers) == {"coarse", "middle", "fine", "hierarchy"}


def test_train_driver():
    out = tiny.run(tiny.TRAIN)
    assert out.correct, out.compared
    assert out.attempted > 0 and out.attempted % 8 == 0 and out.failed == 0
    assert out.end_to_end["train_images_per_s"] > 0
    assert out.end_to_end["setup_s"] > 0
    assert out.trace is None and out.memory_peak_bytes == 0
    _, _, checked = out.sample
    assert len(checked["ids"]) == 3 and len(checked["losses"]) == 3
    assert all(len(set(ids)) == 8 for ids in checked["ids"])
    rate = harness.load_module("metrics", "train.loader_images_per_s").read(
        {"cell": tiny.TRAIN, "trace": None, **out.counters})
    assert rate > 0 and out.counters["loader_images"] == 6 * 8


def test_no_device_metric_off_the_card():
    """The readers of device metrics find nothing to read in a CPU run."""
    out = tiny.run(tiny.OFFLINE)
    obs = {"cell": tiny.OFFLINE, "trace": out.trace, **out.counters}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["source"] == "device_trace" or "mfu" in m["name"]:
            assert harness.load_module("metrics", m["name"]).read(obs) is None


def _command(cwd, *args):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run(
        [sys.executable, "-m", "geobench.run", "--workload",
         "rn50_int8_offline", "--seed", "3000000123", "--seconds", "1",
         "--trace", "0", *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=120)


def test_command_refuses_without_a_card():
    proc = _command(ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "cuda" in proc.stderr.lower()


def test_command_refuses_in_a_bare_checkout(tmp_path):
    """With only BENCHMARK.json and the benchmark's own files there is
    no program to measure: no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "geobench", tmp_path / "geobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _command(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""

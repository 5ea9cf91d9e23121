"""Nothing the benchmark imports, and nothing loaded after a run of it, is
JAX or the JAX package: top-level names compared whole, so the port
(`geoestimation_tpu_torch`) passes."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from geobench import harness

GEOBENCH = Path(__file__).resolve().parents[1]
ROOT = GEOBENCH.parent


def test_no_banned_import_in_the_sources():
    for path in GEOBENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in harness.BANNED_MODULES, \
                    (path, name)


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "geoestimation_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.foo", sys)
    assert harness.banned_modules() == ["jaxlib"]


def test_nothing_banned_after_a_run():
    code = ("import torch; torch.set_num_threads(2)\n"
            "from geobench.tests import tiny\n"
            "from geobench import harness, control, run, trace\n"
            "for m in ('offline', 'train'):\n"
            "    harness.load_module('drivers', m)\n"
            "assert tiny.run(tiny.OFFLINE).correct\n"
            "print('BANNED', harness.banned_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "BANNED []" in proc.stdout


def test_a_reader_that_loads_jax_stops_the_run(monkeypatch):
    """The look for banned modules comes after the per-layer readers: a
    reader whose import puts `jax` into `sys.modules` stops the run before
    any result is printed."""
    import argparse
    import types

    from geobench import run
    from geobench.tests import tiny

    class Reader:
        def __init__(self):
            sys.modules["jax"] = types.ModuleType("jax")

        @staticmethod
        def read(obs):
            return 1.0

    real = harness.load_module
    bench = {"workloads": [{"name": "tiny_offline", "chips": 1}],
             "end_to_end": [{"name": "images_per_s", "unit": "images/s"},
                            {"name": "setup_s", "unit": "s"}],
             "per_layer": [{"name": "stub", "unit": "%",
                            "moves": "images_per_s",
                            "workloads": ["tiny_offline"]}]}
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.setattr(harness, "load_benchmark", lambda: bench)
    monkeypatch.setattr(harness, "load_cell",
                        lambda name: tiny.cell(tiny.OFFLINE))
    monkeypatch.setattr(harness, "load_module", lambda kind, name: (
        Reader() if kind == "metrics" else real(kind, name)))
    args = argparse.Namespace(workload="tiny_offline", seed=5, seconds=1.0,
                              trace=1)
    try:
        with pytest.raises(SystemExit, match="jax"):
            run.measure(args, device="cpu")
    finally:
        sys.modules.pop("jax", None)

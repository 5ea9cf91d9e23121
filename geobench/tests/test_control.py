"""The control: the reference rounded to the precision below the cell's
(int4 below int8, fp8 e4m3 below bf16), put in the program's place, fails
the cell's limits, and the program passes them; in the training cell the
reference on half of each batch fails them too. Here at a size a CPU test
run holds (resnet14 at 64 px, the published class counts); on the card,
`test_control_on_the_card` at each cell's own size on three seeds."""

import json

import pytest
import torch

from geobench import control, harness
from geobench.tests import tiny

BENCH = json.loads((harness.HERE.parent / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("precision", ["int8", "bf16"])
def test_control_fails_the_limits(precision):
    real = next(harness.load_cell(w["name"]) for w in BENCH["workloads"]
                if harness.load_cell(w["name"])["precision"] == precision)
    c = tiny.cell(tiny.OFFLINE, **(tiny.INT8 if precision == "int8"
                                   else tiny.BF16))
    c["config"] = dict(c["config"], class_counts=[3298, 7202, 12893])
    c["traffic"] = dict(c["traffic"], batch=8, pool=16, check_images=16)
    c["limits"] = real["limits"]
    torch.set_num_threads(2)
    row = control.readings(c, 11, 0.5, True, device="cpu")
    assert all(row["program"][k] <= v for k, v in c["limits"].items())
    assert any(row["precision"][k] > v for k, v in c["limits"].items())


def test_train_controls_fail_the_limits():
    """The training cell's controls at the tiny size (resnet14 at 64 px,
    batch 8), against limits set the same way from the tiny size's own
    readings on seeds 11-13 (program: loss_gap 8.2e-4, median-leaf gaps
    0.0027 at most; fp8 training: loss_gap 5.8e-3 or more; half the batch:
    median-leaf gaps 0.28 or more): the program passes, the reference in
    fp8 and the reference on half of each batch each fail."""
    torch.set_num_threads(2)
    row = control.readings(tiny.TRAIN, 11, 0.2, True, device="cpu")
    limits = tiny.TRAIN["limits"]
    assert all(row["program"][k] <= v for k, v in limits.items())
    for kind in ("precision", "half_batch"):
        assert any(row[kind][k] > v for k, v in limits.items()), kind


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    c = harness.load_cell(cell)
    for seed in (3100000001, 3100000002, 3100000003):
        row = control.readings(c, seed, 3.0, True)
        assert all(row["program"][k] <= v for k, v in c["limits"].items())
        kinds = harness.load_module("drivers", c["driver"]).KINDS
        for kind in kinds:
            assert any(row[kind][k] > v for k, v in c["limits"].items())

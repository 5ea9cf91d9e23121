"""The readings that a cell's limits are set from, on the card:

    python3 -m geobench.control --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] --control-seeds <k>

For each seed, one run of the cell's timed path (a short window at the
cell's own load and sizes) and its numbers compared against the float32
reference: the lower readings. For the first `k` seeds also each of the
loop kind's controls (its driver's `KINDS`): "precision", the reference
rounded to the precision below the cell's (`reference/quant.py`: int4
below int8, fp8 e4m3 below bf16) put in the program's place on the very
inputs the run judged; for training also "half_batch", the reference on
half of each batch. Each is judged the same way: the upper readings. One
JSON line a seed; the benchmark's own runs never run these.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402


def readings(cell, seed, seconds, control, device=None):
    """{"seed", "program": {name: value}, and with `control` one entry a
    control kind: {name: value}} of one seed of `cell`
    (`harness.load_cell`)."""
    import torch

    from . import harness
    from .drivers.common import Context, free

    device = torch.device(device or "cuda")
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=False,
                  device=device, t0=time.perf_counter())
    driver = harness.load_module("drivers", cell["driver"])
    out = driver.run(ctx)
    row = {"seed": seed, "program": out.readings}
    for kind in driver.KINDS if control else ():
        free(device)
        row[kind] = driver.control(ctx, out, kind)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m geobench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    from . import harness

    cell = harness.load_cell(args.workload)
    for i, seed in enumerate(args.seeds):
        row = readings(cell, seed, args.seconds, i < args.control_seeds)
        print("control " + json.dumps(row), flush=True)


if __name__ == "__main__":
    main()

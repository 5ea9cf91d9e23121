"""Runs one cell of the benchmark once and prints its result line.

    python3 -m geobench.run --workload <cell> --seed <n> --seconds <s> --trace 0|1

From the root of a checkout that holds `BENCHMARK.json`. The cell is set
up (weights, partitionings and inputs made from the seed, the port's
engine built and warmed up: `setup_s`), measured for `--seconds`, and its
answers are held against the plain reference. The last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer metrics),
`device`, with `--trace 1` `breakdown`, and last `checks`, each number
compared beside its limit (also the last lines of standard error).

It refuses to run, and prints no result, without as many CUDA cards as the
cell asks for, and if the JAX package or JAX was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m geobench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(args, device=None, t0=None):
    """(result line, numbers compared) of one run, or raises SystemExit.
    `device` other than None skips the look for cards (the CPU tests)."""
    import torch

    from . import harness
    from .drivers.common import Context

    bench = harness.load_benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        raise SystemExit(f"geobench: BENCHMARK.json has no workload "
                         f"{args.workload!r}")
    cell = harness.load_cell(args.workload)
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("geobench: torch.cuda.is_available() is false; "
                             "the benchmark measures CUDA cards only")
        if torch.cuda.device_count() < entry["chips"]:
            raise SystemExit(f"geobench: {args.workload} needs "
                             f"{entry['chips']} CUDA cards, "
                             f"{torch.cuda.device_count()} found")
        device = torch.device("cuda", 0)
    else:
        device = torch.device(device)
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=device,
                  t0=T0 if t0 is None else t0)
    driver = harness.load_module("drivers", cell["driver"])
    out = driver.run(ctx)

    e2e, per_layer = harness.cell_metrics(bench, args.workload)
    metrics = {}
    if args.trace:
        obs = {"cell": cell, "trace": out.trace, "chips": entry["chips"],
               **out.counters}
        for m in per_layer:
            value = harness.load_module("metrics", m["name"]).read(obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    dev = harness.device_info(device, entry["chips"], out.memory_peak_bytes,
                              out.trace if args.trace else None)
    result = {"correct": out.correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if args.trace and out.trace is not None:
        result["breakdown"] = out.trace.breakdown()
        print(f"trace: {out.trace.calls} calls, {out.trace.extra}",
              file=sys.stderr)
    # last, once the readers have run too: whatever they loaded counts
    found = harness.banned_modules()
    if found:
        raise SystemExit("geobench: loaded modules the benchmark may not "
                         "load: " + ", ".join(found))
    return result, out.compared


def main(argv=None):
    from . import harness

    result, compared = measure(parse(argv))
    harness.emit(result, compared)


if __name__ == "__main__":
    sys.exit(main())

"""Checks of the port's spans (`geoestimation_tpu_torch/utils/spans.py`) on
the card, against the profiler's own trace and against a run without them.
Run from the root of a checkout, on a machine with a CUDA card:

  python3 -m geoestimation_tpu_torch.tools.span_check card
      Do the spans (FUNCTION-scope record-function ranges) stay off the
      device's timeline? A `record_function` range (USER_SCOPE) is traced
      beside them as the positive control, which the profiler mirrors there.

  python3 -m geoestimation_tpu_torch.tools.span_check traced TAG \\
      --workload CELL --seed N --seconds S --trace 1 [--out DIR]
      One benchmark run (`geobench.run`) whose traced window is kept whole:
      the device operations and idle gaps by name, the span summary, and
      for each root span (`engine.predict_batch`, `train.step`) the host's
      time in blocking CUDA runtime calls beside its `.wait` spans. Writes
      `DIR/TAG.json` (DIR defaults to `span_check/`) and prints one
      `SUMMARY` line.

  python3 -m geoestimation_tpu_torch.tools.span_check oncost \\
      --workload CELL --seed N --seconds S --trace 1 [--rounds R]
      The spans' cost in one process: after the measured window, the cell's
      own loop runs in blocks of about 0.8 s, each under the traced window's
      profiler, with the spans on and off in turns (on, off, off, on, ...);
      prints ms per call of each, and the paired differences' median, mean
      and standard error. Exits before the benchmark's check.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

ROOTS = ("engine.predict_batch", "train.step")
# runtime calls in which the host can wait for the card
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync",
            "cudaMemcpy2DAsync")


def _inside(intervals, t):
    return any(a <= t <= b for a, b in intervals)


def blocking(host, root):
    """Per call of the span `root`, from the host events (name, start,
    end) of one thread, times in microseconds: {"calls", "root_ms" (its
    wall), "wait_ms" (its outermost `.wait` spans), "blocking_ms" (its
    blocking runtime calls), "blocking_outside_waits_ms", "host_ms" (wall
    less waits, what `engine.host_ms` reads)}, or None."""
    roots = [(a, b) for n, a, b in host if n == root]
    if not roots:
        return None
    waits = sorted((a, b) for n, a, b in host if n.endswith(".wait")
                   and _inside(roots, (a + b) / 2))
    outer = [w for w in waits
             if not any(o != w and o[0] <= w[0] and w[1] <= o[1]
                        for o in waits)]
    calls_in = [(a, b) for n, a, b in host if n in BLOCKING
                and _inside(roots, (a + b) / 2)]
    outside = [(a, b) for a, b in calls_in
               if not _inside(outer, (a + b) / 2)]
    per = 1e-3 / len(roots)

    def total(iv):
        return sum(b - a for a, b in iv) * per

    return {"calls": len(roots), "root_ms": total(roots),
            "wait_ms": total(outer), "blocking_ms": total(calls_in),
            "blocking_outside_waits_ms": total(outside),
            "host_ms": total(roots) - total(outer)}


def card():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from geoestimation_tpu_torch.utils import spans

    print("torch", torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    x = torch.randn(2048, 2048, device="cuda")
    (x @ x).sum().item()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            with spans.span("check.outer", device=True, request=1):
                with spans.span("check.inner"):
                    y = x @ x
            with record_function("control.user_scope"):
                y = y @ x
        torch.cuda.synchronize()
    dev = sorted({e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA})
    print("span names on the device:",
          [n for n in dev if n.startswith("check.")])
    print("control on the device:",
          [n for n in dev if n.startswith("control.")])
    print("host events (name, scope):", sorted(
        {(e.name, e.scope) for e in prof.events()
         if e.device_type != DeviceType.CUDA
         and e.name.startswith(("check.", "control."))}))
    print(json.dumps(spans.summary()))


def _option(argv, flag, default):
    """(the value of `flag` in `argv` or `default`, `argv` without it)."""
    if flag not in argv:
        return default, argv
    i = argv.index(flag)
    return argv[i + 1], argv[:i] + argv[i + 2:]


def traced(tag, argv):
    from torch.autograd import DeviceType

    import geobench.trace as tr
    from geobench import harness, run

    kept = {}
    reduce_events = tr.reduce_events

    def keep(events, calls, wall_s):
        t = reduce_events(events, calls, wall_s)
        by_thread = {}
        for e in events:
            if e.device_type != DeviceType.CUDA:
                by_thread.setdefault(e.thread, []).append(
                    (e.name, e.time_range.start, e.time_range.end))
        kept.update(device_s=t.device_s, idle_by_host=t.idle_by_host,
                    calls=calls, busy_s=t.busy_s, window_s=t.window_s,
                    blocking={root: b for root in ROOTS
                              for host in by_thread.values()
                              if (b := blocking(host, root))})
        return t

    out, argv = _option(argv, "--out", "span_check")
    tr.reduce_events = keep
    result, compared = run.measure(run.parse(argv))
    try:
        import geoestimation_tpu_torch.utils.spans as spans
        kept["spans"] = spans.summary()
    except ModuleNotFoundError:
        kept["spans"] = None
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{tag}.json"), "w") as f:
        json.dump({"result": result, "trace": kept}, f)
    harness.emit(result, compared)
    names = [n for n in kept.get("device_s", {})
             if n.split(".")[0] in ("engine", "models", "train", "serve")]
    idle = kept.get("idle_by_host", {})
    print("SUMMARY", tag, json.dumps({
        "correct": result["correct"],
        "metrics": {k: v["value"] for k, v in result["metrics"].items()},
        "busy_s": kept.get("busy_s"), "window_s": kept.get("window_s"),
        "calls": kept.get("calls"), "span_names_on_device": names,
        "outside_share": idle.get("host outside any operation", 0.0)
        / max(sum(idle.values()), 1e-12),
        "blocking": kept.get("blocking")}), flush=True)


def oncost(argv):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import geobench.trace as tr
    import geoestimation_tpu_torch.utils.spans as spans
    from geobench import run

    rounds, argv = _option(argv, "--rounds", 20)
    rounds = int(rounds)
    on_span = spans._Span

    def off_span(name, device, request):
        return spans._OFF

    def blocks(step, seconds, sync):
        t = time.perf_counter()
        n = 0
        while n < 3 or time.perf_counter() - t < 0.5:
            step()
            n += 1
        sync()
        k = max(4, int(0.8 / ((time.perf_counter() - t) / n)))
        ms = {"on": [], "off": []}
        for r in range(rounds):
            for arm in (("on", "off") if r % 2 == 0 else ("off", "on")):
                spans._Span = on_span if arm == "on" else off_span
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]):
                    with record_function(tr.WINDOW):
                        sync()
                        t0 = time.perf_counter()
                        for _ in range(k):
                            step()
                        sync()
                        ms[arm].append((time.perf_counter() - t0) / k * 1e3)
                spans._Span = on_span
                spans.reset()
        diff = [100 * (a / b - 1) for a, b in zip(ms["on"], ms["off"])]
        print("ONCOST", json.dumps({
            "argv": argv, "calls_per_block": k, "rounds": rounds,
            "off_ms": statistics.median(ms["off"]),
            "on_ms": statistics.median(ms["on"]),
            "diff_pct_median": statistics.median(diff),
            "diff_pct_mean": statistics.fmean(diff),
            "diff_pct_se": statistics.stdev(diff) / len(diff) ** 0.5,
            "diff_pct_quartiles": statistics.quantiles(diff, n=4),
            "raw": ms}), flush=True)
        torch.cuda.synchronize()
        os._exit(0)

    tr.trace_loop = blocks
    run.measure(run.parse(argv))


def main(argv):
    if argv[:1] == ["card"]:
        card()
    elif argv[:1] == ["traced"] and len(argv) > 1:
        traced(argv[1], argv[2:])
    elif argv[:1] == ["oncost"]:
        oncost(argv[1:])
    else:
        sys.exit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])

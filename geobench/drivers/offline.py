"""The closed loop of a batch caller: one caller of
`InferenceEngine.predict_batch`, each call a batch of the traffic's photos
drawn in turn from a seeded pool held in host memory, the next call as soon
as the last one answers. `images_per_s` is the photos answered in the window
over the window's seconds.

The traced run profiles a few seconds of the same loop after the window.
The check draws whole calls of the window from the seed and holds their
answers against the float32 reference."""

from __future__ import annotations

import time

import numpy as np

from .. import harness
from .common import TRACE_SECONDS, Outcome, Phases, free, peak_bytes, sync


def run(ctx):
    cell, device, seed = ctx.cell, ctx.device, ctx.seed
    cfg, traffic = cell["config"], cell["traffic"]
    batch, n_pool = traffic["batch"], traffic["pool"]
    n_slots = n_pool // batch

    phases = Phases(ctx.t0)
    phases.mark("imports")
    sd = harness.make_state_dict(cfg, seed, device)
    parts = harness.make_partitionings(cfg, seed)
    pool = harness.make_photos(n_pool, cfg["base"], seed, device)
    phases.mark("inputs")
    engine = harness.build_engine(cell, sd, parts, device)
    del sd
    phases.mark("engine")

    def call(j):
        k = j % n_slots
        return engine.predict_batch(pool[k * batch:(k + 1) * batch])

    for j in range(traffic["warmup_calls"]):
        call(j)
    sync(device)
    phases.mark("warm-up")
    phases.report()
    setup_s = time.perf_counter() - ctx.t0

    answers, j = [], 0
    start = time.perf_counter()
    while time.perf_counter() - start < ctx.seconds:
        answers.append(call(j))
        j += 1
    window_s = time.perf_counter() - start
    images_per_s = j * batch / window_s
    peak = peak_bytes(device)

    trace = None
    if ctx.trace and device.type == "cuda":
        from ..trace import trace_loop

        k = iter(range(j, j + 10 ** 9))
        trace = trace_loop(lambda: call(next(k)), TRACE_SECONDS,
                           lambda: sync(device))
    del engine
    free(device)

    rng = np.random.default_rng([seed, 3])
    picks = np.sort(rng.choice(len(answers), min(
        len(answers), traffic["check_images"] // batch), replace=False))
    images = np.concatenate([pool[(p % n_slots) * batch:
                                  (p % n_slots + 1) * batch] for p in picks])
    got = {key: tuple(np.concatenate([answers[p][key][i] for p in picks])
                      for i in range(3)) for key in answers[0]}
    del answers
    readings = harness.judge_answers(
        cell, harness.make_state_dict(cfg, seed, device),
        harness.make_partitionings(cfg, seed), images, got, device)
    return Outcome(
        attempted=j * batch, failed=0,
        end_to_end={"images_per_s": images_per_s, "setup_s": setup_s},
        compared=harness.checks(cell, readings, 0),
        readings=readings,
        memory_peak_bytes=peak, trace=trace,
        counters={"images_per_s": images_per_s, "calls": j,
                  "window_s": window_s},
        sample=(images, got))



KINDS = ("precision",)


def control(ctx, out, kind):
    """The readings of the reference rounded to the precision below the
    cell's (int4 below int8, fp8 e4m3 below bf16), put in the program's
    place on the very photos the run judged, and judged the same way."""
    from ..reference.quant import CONTROLS

    assert kind == "precision", kind
    cell, seed, device = ctx.cell, ctx.seed, ctx.device
    cfg = cell["config"]
    images, _ = out.sample
    sd = harness.make_state_dict(cfg, seed, device)
    parts = harness.make_partitionings(cfg, seed)
    got = harness.control_answers(cell, sd, parts, images, device,
                                  CONTROLS[cell["precision"]])
    return harness.judge_answers(cell, sd, parts, images, got, device)

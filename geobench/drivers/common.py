"""What a driver hands back to `geobench.run`."""

from __future__ import annotations

from dataclasses import dataclass, field

TRACE_SECONDS = 3.0     # the traced sub-window: a few seconds of the loop


@dataclass
class Context:
    cell: dict          # the cell's file, its configuration and traffic
    seed: int
    seconds: float
    trace: bool
    device: object      # torch.device
    t0: float           # time.perf_counter() when the process began


@dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: dict                 # metric name -> value
    compared: list                   # [(name, value, limit)]
    memory_peak_bytes: int = 0
    trace: object = None             # geobench.trace.Trace, CUDA only
    counters: dict = field(default_factory=dict)   # for per-layer readers
    sample: tuple = None             # (photos, answers) that were judged
    readings: dict = None            # every reading of the check

    @property
    def correct(self):
        return all(value <= limit for _, value, limit in self.compared)


class Phases:
    """Host seconds of each phase of a set-up, printed to standard error."""

    def __init__(self, t0):
        self.last, self.spent = t0, []

    def mark(self, name):
        import time

        now = time.perf_counter()
        self.spent.append((name, now - self.last))
        self.last = now

    def report(self):
        import sys

        print("setup: " + ", ".join(f"{n} {s:.3f} s" for n, s in self.spent),
              file=sys.stderr)


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device):
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def peak_bytes(device):
    """The card's peak of allocated memory since the process began."""
    import torch

    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)

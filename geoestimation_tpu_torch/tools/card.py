"""The card the tools measure on: the check that there is one, its label,
its published peaks, and a CUDA-event timer."""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from ..eval.engine import resolve_device

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak, H100 SXM
H100_INT8_OPS = 1979e12       # dense int8 tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12    # HBM3 rate, H100 SXM


def require_cuda(tool):
    """Raises unless a CUDA card is there; sets float32 convs and matmuls to
    run in float32, not TF32, as the engine does. There is no CPU mode of a
    measurement."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: torch.cuda.is_available() is false; this "
                         "tool measures the CUDA card and has no CPU mode")
    resolve_device("cuda")


def card_label():
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0].strip()


def time_ms(fn, reps=20, warmup=3):
    """Median of `reps` CUDA-event timings of fn(), after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(flops, nbytes, peak=H100_BF16_FLOPS):
    """(least time in ms, 'operations' or 'bytes'): the larger of the
    operations over the `peak` rate (bf16 by default) and the bytes over
    the memory rate."""
    flop_ms = 1e3 * flops / peak
    byte_ms = 1e3 * nbytes / H100_BYTES_PER_S
    return max(flop_ms, byte_ms), ("bytes" if byte_ms >= flop_ms
                                   else "operations")

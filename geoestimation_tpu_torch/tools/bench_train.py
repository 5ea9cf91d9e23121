"""Training-step throughput of the port.

    python -m geoestimation_tpu_torch.tools.bench_train [--batch 128] \\
        [--iters 20] [--arch resnet50] [--remat] [--cpu]

The counterpart of the JAX package's `tools/bench_train.py`: the full train
step (random crop and flip of uint8 256-px images -> bf16 forward in train
mode -> the sum of the three heads' cross-entropies at the published class
counts -> backward -> SGD with momentum 0.9 at lr 0.01) on seeded synthetic
data kept on the device. Prints one JSON line: images/s, ms/step and the
peak device memory, with the device it ran on. Runs on CUDA unless --cpu.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..eval.engine import resolve_device
from ..models.classifier import MultiPartitioningClassifier
from ..train.init import init_weights
from ..train.optim import Optimizer, constant_schedule
from ..train.step import TrainState, train_step
from .world import REAL_CLASS_COUNTS

BASE = 256


def setup(batch, arch="resnet50", remat=False, device="cuda", seed=0,
          n_classes=REAL_CLASS_COUNTS, crop=224, base=BASE):
    """(state, images, labels, step) for `batch` seeded uint8 `base`-px
    images and labels on `device`; step() runs one train step and returns
    its metrics."""
    device = resolve_device(device)
    model = init_weights(MultiPartitioningClassifier(
        n_classes, arch, torch.bfloat16, remat=remat), seed)
    model = model.to(device, memory_format=torch.channels_last)
    state = TrainState(model, Optimizer(model.parameters(),
                                        constant_schedule(0.01),
                                        momentum=0.9))
    gen = torch.Generator().manual_seed(seed)
    images = torch.randint(0, 256, (batch, base, base, 3), dtype=torch.uint8,
                           generator=gen).to(device)
    labels = torch.stack([torch.randint(0, n, (batch,), generator=gen)
                          for n in n_classes]).to(device)

    def step():
        return train_step(state, images, labels, seed, crop=crop)[1]

    return state, images, labels, step


def measure(step, iters, device):
    """(ms per step, the last step's metrics): one warm-up step, then
    `iters` steps between two synchronizations."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    step()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        metrics = step()
    sync()
    return 1e3 * (time.perf_counter() - t0) / iters, metrics


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--arch", default="resnet50")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    state, _, _, step = setup(args.batch, args.arch, args.remat,
                              "cpu" if args.cpu else "cuda")
    device = next(state.model.parameters()).device
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ms, metrics = measure(step, args.iters, device)
    out = {
        "metric": f"train_images_per_sec_{args.arch}"
                  + ("_remat" if args.remat else ""),
        "value": args.batch * 1e3 / ms,
        "unit": "images/s",
        "batch": args.batch,
        "ms_per_step": ms,
        "loss": float(metrics["loss"]),
        "peak_mem_GiB": (torch.cuda.max_memory_allocated() / 2 ** 30
                         if device.type == "cuda" else None),
        "device": (torch.cuda.get_device_name(0) if device.type == "cuda"
                   else "cpu"),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

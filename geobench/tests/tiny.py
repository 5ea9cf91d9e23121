"""Tiny cells for the CPU tests: resnet14 at 64 px crops of 72 px photos,
three nested partitionings of 6 / 12 / 24 cells, each loop kind at a few
photos or steps."""

from __future__ import annotations

import copy
import time

import torch

from geobench import harness
from geobench.drivers.common import Context

CONFIG = {"name": "tiny", "arch": "resnet14", "stage_sizes": [1, 1, 1, 1],
          "feature_dim": 2048, "class_counts": [6, 12, 24], "crop": 64,
          "base": 72, "n_crops": 10}
LIMITS = {"max_gap": 0.1, "mean_gap": 0.003}
INT8 = {"int8": True, "calib_stat": "auto", "int8_scales_path": None,
        "int8_persist": False}
BF16 = {"fast": True, "use_pallas": True}

OFFLINE = {"name": "tiny_offline", "driver": "offline", "precision": "int8",
           "engine": INT8, "limits": LIMITS, "config": CONFIG,
           "traffic": {"batch": 4, "pool": 16, "warmup_calls": 1,
                       "check_images": 8}}

RECIPE = {"dtype": "bfloat16", "batch_size": 8, "lr": 0.01, "momentum": 0.9,
          "weight_decay": 0.0001, "milestones": [4, 8, 12], "gamma": 0.5,
          "warmup_epochs": 0.5, "image_size": 64, "crop_scale": [0.66, 1.0],
          "num_workers": 2}
TRAIN = {"name": "tiny_train", "driver": "train", "precision": "bf16",
         "recipe": RECIPE, "config": dict(CONFIG, partitionings=[
             "coarse", "middle", "fine"]),
         "limits": {"loss_gap": 0.003, "grad_gap_median": 0.04,
                    "change_gap_median": 0.04},
         "traffic": {"records": 48, "shards": 4,
                     "sizes": [[256, 256], [300, 256], [256, 280]],
                     "quality": [85, 92], "held_batches": 6,
                     "warmup_steps": 1}}


def cell(base, **engine):
    """A copy of `base` with its engine's keywords replaced by `engine`
    where given."""
    out = copy.deepcopy(base)
    if engine:
        out["engine"] = engine
        out["precision"] = "int8" if engine.get("int8") else "bf16"
    return out


def run(c, seed=2 ** 31 + 12345, seconds=1.0):
    """One run of the tiny cell `c` on the CPU: the driver's `Outcome`."""
    torch.set_num_threads(2)
    ctx = Context(cell=c, seed=seed, seconds=seconds, trace=False,
                  device=torch.device("cpu"), t0=time.perf_counter())
    return harness.load_module("drivers", c["driver"]).run(ctx)

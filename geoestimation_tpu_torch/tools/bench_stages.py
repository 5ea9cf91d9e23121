"""Per-stage timing of the fast path by cumulative prefixes, on the card.

    python -m geoestimation_tpu_torch.tools.bench_stages [variant ...]

The counterpart of the JAX package's `tools/bench_stages.py`. On the seeded
full-width world (`tools/world.py`) at batch 64 (640 crops) it times the
prefixes ingest, +stem, +layer1, ..., +layer4 and the whole forward through
the head, over `apply.stage_fns` and `apply.head_logits`, with CUDA events
(median of 10 after 3 warm-up calls), and prints each prefix's time and its
delta over the one before: the cost of each stage in context. PyTorch runs
eagerly, so unlike XLA nothing is fused across a cut point and the deltas
are the stages' own times.

Variants (build_fast_apply keywords as `bench_kernels`' e2e): noPallas, L1,
L2, L1L2, L1L2-s2, and int8: the int8 path (`models/quant.py`, every conv
on `conv_s8`), its ingest `eval_pipeline_s8`, its scales an absmax
calibration on the first 8 images, and int8-stem: the int8 stem's time
split into its space-to-depth buffer, its `conv_s8` launch and its 9-tap
max pool (default: all). It runs on a CUDA card only and raises without
one.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..ingest.pipeline import eval_pipeline, eval_pipeline_s8
from ..models import quant
from ..models.fast_infer import build_fast_apply
from . import world
from .bench_kernels import FAST_VARIANTS
from .card import card_label, require_cuda, time_ms

VARIANTS = {name.removeprefix("fast-"): kw
            for name, kw in FAST_VARIANTS.items()}
VARIANTS["int8"] = None
VARIANTS["int8-stem"] = None
PREFIXES = ("ingest", "stem", "layer1", "layer2", "layer3", "layer4", "head")


def bf16_ingest(images_u8, n_crops):
    return eval_pipeline(images_u8, n_crops=n_crops, crop=224,
                         dtype=torch.bfloat16)


def s8_ingest(images_u8, n_crops):
    return eval_pipeline_s8(images_u8, n_crops=n_crops, crop=224)


def stage_prefix(apply, ingest, k, n_crops=10):
    """uint8 images -> the output of `ingest` and the first k stage
    functions; past the last stage, the head's logits."""
    stage_fns = apply.stage_fns

    @torch.inference_mode()
    def run(images_u8):
        x = ingest(images_u8, n_crops)
        for fn in stage_fns[:k]:
            x = fn(x)
        return apply.head_logits(x) if k > len(stage_fns) else x

    return run


def int8_apply(sd, images):
    """The int8 path on the card, calibrated (absmax) on 8 of `images`."""
    scales = quant.calibrate(sd, [images[:8].cpu().numpy()], world.ARCH,
                             stat="absmax", device="cuda")
    return quant.build_int8_apply(quant.quantize_model(sd, world.ARCH),
                                  scales, n_classes=world.REAL_CLASS_COUNTS,
                                  device="cuda")


def bench_stem_split(sd, images, label, reps=10):
    """The int8 stem on the ingested batch, whole and in its three parts:
    the `conv_s8` launch and the max pool timed alone on the inputs the
    stem gave them, and the space-to-depth buffer timed as the stem with
    the convolution answering from a cache and the pool passing through."""
    real_conv, real_pool = quant.conv_s8, quant.max_pool_3x3_s2
    route = {"conv": real_conv}
    seen = {}

    def record(*args, **kw):
        seen["call"], seen["y"] = (args, kw), real_conv(*args, **kw)
        return seen["y"]

    quant.conv_s8 = lambda *args, **kw: route["conv"](*args, **kw)
    try:
        apply = int8_apply(sd, images)       # binds the dispatcher
    finally:
        quant.conv_s8 = real_conv
    with torch.inference_mode():
        x = s8_ingest(images, 10)
        route["conv"] = record
        apply.stem_fn(x)
        route["conv"] = real_conv
        args, kw = seen["call"]
        y = seen["y"]
        stem_ms = time_ms(lambda: apply.stem_fn(x), reps=reps)
        conv_ms = time_ms(lambda: real_conv(*args, **kw), reps=reps)
        pool_ms = time_ms(lambda: real_pool(y), reps=reps)
        route["conv"] = lambda *a, **k: y
        quant.max_pool_3x3_s2 = lambda t: t
        try:
            buffer_ms = time_ms(lambda: apply.stem_fn(x), reps=reps)
        finally:
            route["conv"], quant.max_pool_3x3_s2 = real_conv, real_pool
    print("bench_stages " + json.dumps({
        "variant": "int8-stem", "stem_ms": stem_ms,
        "s2d_buffer_ms": buffer_ms, "conv_s8_ms": conv_ms,
        "max_pool_ms": pool_ms,
        "rest_ms": stem_ms - buffer_ms - conv_ms - pool_ms,
        "buffer_shape": list(args[0].shape), "conv_out_shape": list(y.shape),
        "batch": len(images), "card": label}), flush=True)


def bench_variant(name, sd, images, label, reps=10):
    if name == "int8-stem":
        return bench_stem_split(sd, images, label, reps)
    if name == "int8":
        apply, ingest = int8_apply(sd, images), s8_ingest
    else:
        apply, ingest = build_fast_apply(
            sd, world.ARCH, n_classes=world.REAL_CLASS_COUNTS, device="cuda",
            **VARIANTS[name]), bf16_ingest
    prev = 0.0
    for k, stage in enumerate(PREFIXES):
        run = stage_prefix(apply, ingest, k)
        ms = time_ms(lambda: run(images), reps=reps)
        print("bench_stages " + json.dumps({
            "variant": name, "prefix": stage, "cum_ms": ms,
            "delta_ms": ms - prev, "batch": len(images), "card": label}),
            flush=True)
        prev = ms


def main(argv=None):
    which = list(sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    unknown = [v for v in which if v not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variant(s) {unknown}; have "
                         f"{list(VARIANTS)}")
    require_cuda("bench_stages")
    label = card_label()
    print(f"card: {label}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    _, sd, _ = world.build_world()
    rng = np.random.default_rng(world.SEED)
    images = torch.as_tensor(
        rng.integers(0, 256, (64, 256, 256, 3), dtype=np.uint8),
        device="cuda")
    for name in which:
        bench_variant(name, sd, images, label)


if __name__ == "__main__":
    main()

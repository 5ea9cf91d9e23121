"""Drives the PyTorch/CUDA port on one GPU and checks it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --planted-faults   # phase 10's training gates
                                             # against planted faults

Phases, in order; any failure exits non-zero and prints no result line:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions, and the build of every CUDA kernel from csrc/ (one nvcc per
     source, all started together; timed);
  2. every kernel against its plain PyTorch version on the card, in bf16, at
     the shapes the main paths give it and at the edges of its tiling, with
     its time, its plain version's, the cuDNN chain's and its bound, and what
     its planner chose (shared memory, blocks per SM, TH, TW, ring stages);
  3. the main path: ten-crop bf16 ResNet50 inference at full width (three
     heads at 3298/7202/12893 classes, random weights from a seed) through
     `InferenceEngine.predict_batch` with the BN-folded fast path and the
     hand-written kernels, first in the default configuration (the
     stride-1 kernel only), then with `use_pallas_s2` (the stride-2 kernel
     too); launch counts of each run, agreement with the unfolded module
     path, and images/s;
  4. host-exact ten-crop: `predict_batch` of a `tta_mode="host_exact"`
     engine on the fast path with the stride-1 kernel, fed
     `decode_batch_tencrop` of 8 seeded non-square JPEGs (seeded uint8 crops
     where Pillow is missing); its launches, and its logits held to the
     module path;
  5. the server: `GeoInferenceServer` on the default fast path (batch 16,
     5 ms wait) answers 128 seeded JPEG requests from 64 client threads in a
     process of their own;
     every answer equals `predict_batch` on the same decoded images, the
     stride-1 kernel launched 6 times per micro-batch, `/healthz` and
     `/stats` answer; one line with requests/s, p50/p99 latency, mean batch
     occupancy, the decode backend and the card;
  6. int8 (`--precision 8`): `InferenceEngine(int8=True)` on the same
     world calibrates (`calib_stat="auto"`) on its first batch, then one
     `predict_batch` launches the int8 convolution 53 times; its per-crop
     logits equal the plain int8 network's on the card (same scales) and
     correlate >= 0.98 with the float32 module path's per head; ten-crop
     images/s at batch 64 beside phase 3's bf16 figure; then the same on
     phase 4's host ten-crops (`tta_mode="host_exact"`, 5-D batches). The
     int8 convolution's check against its plain version (bit for bit, at
     every convolution shape of the int8 ResNet50) runs in phase 2;
  7. the TTA variants: each kernel against its plain version at the new
     shapes of feature TTA's trunk (8 base images of 256 px and their
     mirrors: the stride-1 kernel on 64- and 32-wide planes, the stride-2
     one at the 64-wide layer2 entry that use_pallas_s2 would give it,
     conv_s8 bit for bit at the stem over a 132-wide buffer and layer1-3 at
     64/32/16, each line with its plan); `InferenceEngine(tta_mode=
     "feature")` at level 3 (8 images), then 1 and 2 (4 images), in bf16 on
     the kernels (6 launches a forward; logits within the fast-path gates
     of the same level on the cuDNN route; `predict_batch`'s classes those
     of its folded logits) and in int8 (53 launches; logits equal to the
     plain int8 network's; calibrated `auto` at level 3, then through the
     scales cache); mirror TTA (`build_mirror_tta_apply`, 12 launches: its
     logits within the fast-path gates of the ten-crop fast path, netM's
     pooled features within the kernel gates of net's on the flipped
     crops); images/s at batch 64 beside the device-TTA figure;
  8. ISN: a scene-gated world at the published class counts (3 scenes,
     70,179 geo-head outputs) whose scene head is the nearest-mean
     classifier of three seeded image families (fit on the float32 module
     path's features of 12 probe images), then on 8 new images of those
     families: every scene routed to, the fast path (6 launches) within
     the fast-path gates of the bf16 module path on the crops whose scene
     margin exceeds the gate, int8 (53 launches, `auto` on its first batch)
     equal to the plain int8 network and correlated >= 0.98 per head with
     the float32 module path on such crops; images/s of each path;
  9. training at baseM's full width: a seeded shard world (4 x 384
     training and 64 validation JPEG records at 256-320 px, labels over
     the three partitionings at the published class counts) trained for
     12 steps by `train_base.main` (ResNet50 bf16, batch 256 at 224 px,
     train_crop_scale (0.66, 1.0), the baseM recipe), validated and
     checkpointed at each epoch end: the loss per step (finite), train
     images/s past the first two steps, peak memory and the host's wait
     for batches, no kernel launched by a train step; `bench_train` at
     batch 256 with and without remat, and on one more step: a finite
     loss, every parameter updated as the optimizer computed, and each
     BatchNorm's running
     statistics 0.9 * old + 0.1 * a plain float32 mean and biased variance
     of its input in that step, and the device time by operator of two
     steps (torch.profiler); an overfit check (25 steps on one batch of 64
     center crops, the last loss under half the first); then the best
     checkpoint served by `InferenceEngine` on the default fast path
     (6 fused_bottleneck launches a forward, logits within the fast-path
     gates of the module path, the same predicted classes) on 8 of the
     validation images;
 10. multi-process, two processes of the port's own CLIs on the card
     (`--coordinator 127.0.0.1:<free port> --num_processes 2 --process_id
     p`, each process `python3 chip_smoke.py --rank ...`, each group with
     its own time limit): on a world of phase 3's weights, 64 seeded JPEGs
     and a meta CSV, `classification.test --fast` in two processes against
     one (the merged table's counts equal or within one image; each image
     whose predictions differ printed with its distances),
     `classification.inference --fast --pallas` (the part files hold one
     process's rows and classes; 6 `fused_bottleneck` launches a forward in
     each rank), `classification.test --precision 8` (each rank defaults
     --calib_dir to the folder and derives the scales one process derives
     from it; 53 `conv_s8` launches a forward in each rank); `train_base`
     on phase 9's world (global batch 256 = 2 x 128, lockstep, 6 steps,
     the first epoch, validated at its end)
     after one process on the same world and seed: finite losses, equal on
     both ranks, every step's within rtol 6e-5 of one process's, step 1's
     batch statistics (from the running statistics) within 5e-3 of one
     process's (the mean in units of the standard deviation, the variance
     relative), the heads' update over the run within 8e-3 of one
     process's (relative, in norm), no kernel launched by a train step
     (`--planted-faults` instead runs a clean pair and pairs with the
     gradient all-reduce, the global BatchNorm sums or their backward's
     sum taken out of their ranks, and fails unless only the clean pair
     holds these gates);
     images/s of both, each rank's peak memory,
     the device group's backend and the gradient all-reduce's ms a step;
     `serve --shard_batch` over the card's local devices (every answer
     `predict_batch`'s); the training pair on two cards with NCCL where
     there are two, else the line {"multi_process": {"nccl": "not run: 1
     card"}}. One JSON line {"multi_process": {...}} each;
 11. one JSON line describing every kernel (with its launches per forward
     on each path), then the result line {"ok": true, "device": {...}}.

Imports torch, numpy and the standard library only, besides the port
(Pillow too, where it is installed, to make and decode JPEGs; phases 9 and
10 need it).
"""

from __future__ import annotations

import contextlib
import io
import json
import multiprocessing
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from geoestimation_tpu_torch.checkpoint import load_checkpoint
from geoestimation_tpu_torch.classification import train_base
from geoestimation_tpu_torch.data import shards
from geoestimation_tpu_torch.eval.engine import InferenceEngine
from geoestimation_tpu_torch.eval.infer import mean_tta_logits, predict_all
from geoestimation_tpu_torch.ingest import decode
from geoestimation_tpu_torch.ingest.pipeline import (
    eval_pipeline,
    eval_pipeline_s8,
    shift_s8,
)
from geoestimation_tpu_torch.models import quant, resnet
from geoestimation_tpu_torch.models.fast_infer import (
    build_fast_apply,
    build_mirror_tta_apply,
)
from geoestimation_tpu_torch.ops import _build
from geoestimation_tpu_torch.ops import conv_s8 as ops8
from geoestimation_tpu_torch.ops import fused_bottleneck as ops
from geoestimation_tpu_torch.serve import GeoInferenceServer
from geoestimation_tpu_torch.tools import bench_train, world
from geoestimation_tpu_torch.tools.bench_kernels import (
    INT8_EDGES,
    INT8_LAUNCHES,
    block_cost,
    block_inputs,
    conv_s8_cost,
    conv_s8_inputs,
    conv_s8_library,
    conv_s8_plan,
    cudnn_chain,
    int8_conv_shapes,
)
from geoestimation_tpu_torch.tools.card import (
    H100_INT8_OPS,
    bound_ms,
    card_label,
    require_cuda,
    time_ms,
)
from geoestimation_tpu_torch.train.optim import Optimizer, constant_schedule
from geoestimation_tpu_torch.train.step import train_step
from geoestimation_tpu_torch.utils.config import load_config

# (label, N, H, W, Cin, Cmid, Cout, projection, launches per forward) of
# each kernel: the blocks of ResNet50 at 224 px that the main paths send to
# it, N = 8 images x 10 crops, and the edges of each kernel's tiling.
SHAPES = {
    "fused_bottleneck": [
        ("layer1.0 56x56 64-64-256 proj", 80, 56, 56, 64, 64, 256, True, 1),
        ("layer1.1-2 56x56 256-64-256", 80, 56, 56, 256, 64, 256, False, 2),
        ("layer2.1-3 28x28 512-128-512", 80, 28, 28, 512, 128, 512, False, 3),
        ("ragged 13x11 64-64-256 proj", 3, 13, 11, 64, 64, 256, True, 0),
        # the edges of the Hopper tiling: K slices partly outside Cin, one
        # image, rows that do not fill a 64-row tile, the layer3 shape
        ("Cin 16 8x8 16-64-128 proj", 2, 8, 8, 16, 64, 128, True, 0),
        ("Cin 48 9x12 48-64-64 proj", 2, 9, 12, 48, 64, 64, True, 0),
        ("N 1 7x7 256-64-256", 1, 7, 7, 256, 64, 256, False, 0),
        ("W 13 6x13 128-128-128", 2, 6, 13, 128, 128, 128, False, 0),
        ("layer3.1-5 14x14 1024-256-1024", 80, 14, 14, 1024, 256, 1024, False,
         0),
        # rows too wide for whole-row tiles: one row by column tiles
        ("wide 3x402 64-64-256 proj", 1, 3, 402, 64, 64, 256, True, 0),
        ("wide 3x700 64-64-64 proj", 1, 3, 700, 64, 64, 64, True, 0),
    ],
    "fused_bottleneck_s2": [
        ("layer2.0 56x56 256-128-512", 80, 56, 56, 256, 128, 512, True, 1),
        # the bench's layer3entry case: 28 wide, the routing keeps it on cuDNN
        ("layer3.0 28x28 512-256-1024", 80, 28, 28, 512, 256, 1024, True, 0),
        # 7 output rows against 4-row tiles, odd output width
        ("ragged 14x10 64-64-256", 3, 14, 10, 64, 64, 256, True, 0),
        ("Cin 48 10x12 48-64-128", 2, 10, 12, 48, 64, 128, True, 0),
        ("layer3.0 at 448 px 56x56 512-256-1024", 2, 56, 56, 512, 256, 1024,
         True, 0),
        # rows too wide for whole-row tiles: one row by column tiles
        ("wide 4x482 64-64-256", 1, 4, 482, 64, 64, 256, True, 0),
        ("wide 4x1200 64-64-128", 1, 4, 1200, 64, 64, 128, True, 0),
    ],
}
STRIDE = {"fused_bottleneck": 1, "fused_bottleneck_s2": 2}
REPLACES = {"fused_bottleneck": "geoestimation_tpu/ops/fused_bottleneck.py:234",
            "fused_bottleneck_s2":
                "geoestimation_tpu/ops/fused_bottleneck.py:359"}
KERNEL_RTOL = KERNEL_ATOL = 0.05     # as tests/test_fused_block.py
KERNEL_MIN_BITWISE = 0.9


def log(msg):
    print(msg, flush=True)


# -- phase 1 -------------------------------------------------------------------

def phase_device():
    require_cuda("chip_smoke")
    label = card_label()
    log(label)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log("tf32: cudnn.allow_tf32=False cuda.matmul.allow_tf32=False")
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s for "
        f"{_build.sources()}")
    summaries = {name: ptxas_summary(report)
                 for name, report in reports.items()}
    for name, report in reports.items():
        # C7519: ptxas put a warpgroup.arrive (a wait for the wgmma in
        # flight) where registers a wgmma uses are touched between products
        arrives = [line for line in report.splitlines() if "C7519" in line]
        for line in report.splitlines():
            if "C7519" not in line and (
                    ("Used" in line and "registers" in line)
                    or "spill" in line or "error" in line):
                log(f"  ptxas {name}: {line.strip()}")
        log(f"  ptxas {name}: {len(arrives)} x C7519 (warpgroup.arrive "
            f"injected to allow use of registers in GMMA)"
            + (f"; first: {arrives[0].strip()}" if arrives else ""))
    return label, summaries


def ptxas_summary(report):
    """{registers, spill_stores, spill_loads, c7519} per entry function of a
    `-Xptxas -v` report, the function named as ptxas names it."""
    out, fn = {}, None

    def entry(name):
        return out.setdefault(name, {"registers": None, "spill_stores": None,
                                     "spill_loads": None, "c7519": 0})

    for line in report.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            entry(fn)
        elif "C7519" in line and "in function '" in line:
            entry(line.split("in function '")[1].split("'")[0])["c7519"] += 1
        elif fn and "spill stores" in line:
            words = line.split()
            out[fn]["spill_stores"] = int(words[words.index("spill") - 2])
            out[fn]["spill_loads"] = int(line.split("spill stores,")[1]
                                         .split()[0])
        elif fn and "Used" in line and "registers" in line:
            words = line.split()
            out[fn]["registers"] = int(words[words.index("Used") + 1])
    return out


# -- phase 2 -------------------------------------------------------------------

def check_kernel(name, label, gen, shapes=None):
    """One kernel against its plain version at each of its shapes (by
    default its SHAPES); returns its JSON entry (launches filled in from the
    main path's run)."""
    kernel, plain = getattr(ops, name), getattr(ops, f"{name}_reference")
    stride = STRIDE[name]
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0,
              "bytes": 0}
    max_err = 0.0
    for shape in SHAPES[name] if shapes is None else shapes:
        label_, n, h, w, cin, cmid, cout, proj, per_fwd = shape
        args = block_inputs(n, h, w, cin, cmid, cout, proj, gen)
        got = kernel(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        g, r = got.float(), ref.float()
        err = float((g - r).abs().max())
        bitwise = float((g == r).float().mean())
        close = bool(torch.allclose(g, r, rtol=KERNEL_RTOL, atol=KERNEL_ATOL))
        max_err = max(max_err, err)
        if not (close and bitwise >= KERNEL_MIN_BITWISE
                and torch.isfinite(g).all()):
            raise RuntimeError(
                f"{name} disagrees with its plain version at {label_}: "
                f"max_abs_err {err}, bitwise {bitwise:.4f}, "
                f"allclose(rtol={KERNEL_RTOL}, atol={KERNEL_ATOL}) {close}")
        del got, ref, g, r
        flops, nbytes = block_cost(n, h, w, cin, cmid, cout, proj, stride)
        ms = time_ms(lambda: kernel(*args))
        plain_ms = time_ms(lambda: plain(*args))
        lib_ms = time_ms(cudnn_chain(args, stride))
        bound, bound_by = bound_ms(flops, nbytes)
        plan = ops.kernel_plan(name, n, h, w, cin, cmid, cout, proj)
        log("kernel-check " + json.dumps({
            "kernel": name, "shape": label_, "N": n, **plan, "max_abs_err": err,
            "bitwise_equal": bitwise, "kernel_ms": ms, "bound_ms": bound,
            "bound_by": bound_by, "plain_ms": plain_ms, "library_ms": lib_ms,
            "launches_per_forward": per_fwd, "card": label}))
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("flops", flops),
                         ("bytes", nbytes)):
            totals[key] += per_fwd * val
        del args
    bound, bound_by = bound_ms(totals["flops"], totals["bytes"])
    return {
        "name": name,
        "route": "cuda",
        "source": f"geoestimation_tpu_torch/csrc/{name}.cu",
        "replaces": REPLACES[name],
        "launches": None,  # filled from the main path's run
        "max_abs_err": max_err,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": totals["library_ms"],
    }


def check_conv_s8(label, gen, ptxas, shapes=None):
    """The int8 convolution against its plain version, bit for bit, at every
    shape of the int8 ResNet50 (N = 80) and the tiling's edges, or at
    `shapes`, with the plan each shape ran and the build's ptxas summary
    (None where the library was built before this run); returns its JSON
    entry (launches filled in from the int8 main path's run)."""
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "ops": 0,
              "bytes": 0}
    if shapes is None:
        shapes = int8_conv_shapes()
        assert sum(c for *_, c in shapes) == INT8_LAUNCHES, shapes
        shapes = shapes + INT8_EDGES
    for label_, key, per_fwd in shapes:
        args, kw = conv_s8_inputs(key, gen)
        got = ops8.conv_s8(*args, **kw)
        torch.cuda.synchronize()
        ref = ops8.conv_s8_reference(*args, **kw)
        err = int((got.int() - ref.int()).abs().max())
        if not torch.equal(got, ref):
            raise RuntimeError(
                f"conv_s8 disagrees with its plain version at {label_}: "
                f"{float((got == ref).float().mean()):.6f} equal, max_abs_err "
                f"{err}")
        ms = time_ms(lambda: ops8.conv_s8(*args, **kw))
        plain_ms = time_ms(lambda: ops8.conv_s8_reference(*args, **kw),
                           reps=5, warmup=1)
        lib_name, lib = conv_s8_library(args, kw)
        lib_ms = time_ms(lib) if per_fwd else None
        nops, nbytes = conv_s8_cost(key)
        bound, bound_by = bound_ms(nops, nbytes, H100_INT8_OPS)
        plan = conv_s8_plan(args[0], args[1], kw)
        log("kernel-check " + json.dumps({
            "kernel": "conv_s8", "shape": label_, "N": key[0], "plan": plan,
            "ptxas": ptxas, "max_abs_err": err, "bitwise_equal": 1.0,
            "kernel_ms": ms, "bound_ms": bound, "bound_by": bound_by,
            "plain_ms": plain_ms, "library_ms": lib_ms, "library": lib_name,
            "launches_per_forward": per_fwd, "card": label}))
        for key_, val in (("ms", ms), ("plain_ms", plain_ms),
                          ("library_ms", lib_ms or 0.0), ("ops", nops),
                          ("bytes", nbytes)):
            totals[key_] += per_fwd * val
        del args, kw, got, ref
    bound, bound_by = bound_ms(totals["ops"], totals["bytes"], H100_INT8_OPS)
    return {
        "name": "conv_s8",
        "route": "cuda",
        "source": "geoestimation_tpu_torch/csrc/conv_s8.cu",
        "replaces": "geoestimation_tpu/models/quant.py:125",
        "launches": None,  # filled from the int8 main path's run
        "max_abs_err": 0.0,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": totals["library_ms"],
    }


def phase_kernels(label, ptxas):
    """Each kernel against its plain version; returns the JSON entries.
    Times are per forward of 8 images x 10 crops, summed over the kernel's
    launches on its main path."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    return [check_kernel(name, label, gen) for name in SHAPES] + [
        check_conv_s8(label, gen, ptxas.get("conv_s8"))]


# -- phase 3 -------------------------------------------------------------------

FAST_RTOL, FAST_ATOL = 0.15, 0.2          # as tests/test_fast_infer.py:110
# launches per forward of each configuration: (fused_bottleneck, _s2)
WANT_DEFAULT, WANT_S2 = (6, 0), (6, 1)


def _check_predictions(engine, preds, n):
    assert sorted(preds) == engine.pred_keys, sorted(preds)
    fine = engine.partitionings[-1]
    for key, (cls, lat, lng) in preds.items():
        part = fine if key == "hierarchy" else next(
            p for p in engine.partitionings if p.name == key)
        assert cls.shape == lat.shape == lng.shape == (n,), key
        assert ((cls >= 0) & (cls < len(part))).all(), key
        np.testing.assert_array_equal(lat, part.lat[cls].astype(np.float32))
        np.testing.assert_array_equal(lng, part.lng[cls].astype(np.float32))


def _counted(fn):
    """(fn(), (fused_bottleneck, fused_bottleneck_s2) launches during it),
    with both counts set to 0 just before."""
    ops.fused_bottleneck.launches = ops.fused_bottleneck_s2.launches = 0
    out = fn()
    return out, (ops.fused_bottleneck.launches,
                 ops.fused_bottleneck_s2.launches)


def _images_per_s(engine, images, reps=5):
    engine.predict_batch(images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.predict_batch(images)   # returns numpy: synchronized
    return reps * len(images) / (time.perf_counter() - t0)


def _hold_logits(name, keys, got, ref, n_rows, rows=None, rtol=FAST_RTOL,
                 atol=FAST_ATOL):
    """Per-crop logits `got` against `ref` (lists over the heads `keys`):
    finite, (n_rows, C), and within rtol/atol over the crops `rows` (all by
    default)."""
    for head, g, r in zip(keys, got, ref):
        if not (torch.isfinite(g).all() and g.shape == r.shape
                == (n_rows, g.shape[-1])):
            raise RuntimeError(f"{name}: bad logits for head {head}: "
                               f"{g.shape}")
        if rows is not None:
            g, r = g[rows], r[rows]
        err = float((g - r).abs().max())
        agree = float((g.argmax(-1) == r.argmax(-1)).float().mean())
        if not torch.allclose(g, r, rtol=rtol, atol=atol):
            raise RuntimeError(
                f"{name} disagrees on head {head}: max_abs_err {err} (rtol "
                f"{rtol}, atol {atol})")
        log(f"{name}, head {g.shape[-1]} wide, {len(g)} crops: "
            f"max_abs_err {err:.4f}, per-crop argmax agreement {agree:.4f}")


def _hold_to_module(name, engine, module, x):
    """The engine's per-crop logits against the unfolded module path's."""
    _hold_logits(f"main path: {name} vs module logits", engine.pred_keys,
                 engine.crop_logits(x), module.crop_logits(x), 10 * len(x))


def _drive(name, engine, images, want):
    """One predict_batch with the counts set to 0 just before; fails unless
    each kernel launched as often as `want` says."""
    preds, launches = _counted(lambda: engine.predict_batch(images))
    log(f"main path: {name} predict_batch({len(images)} images x 10 crops): "
        f"launches fused_bottleneck {launches[0]}, fused_bottleneck_s2 "
        f"{launches[1]} (want {want[0]}, {want[1]} per forward)")
    if launches != want:
        raise RuntimeError(f"{name}: launches {launches} in one forward, "
                           f"want {want}")
    _check_predictions(engine, preds, len(images))
    return preds, launches


def phase_main_path(label, engine):
    """Returns each kernel's launch count on its main path's run, and the
    default fast engine and the module engine, for the later phases."""
    t0 = time.perf_counter()
    fast = engine(fast=True, use_pallas=True)
    assert fast.hierarchy.valid.all(), "a fine cell lacks an ancestor"
    log(f"main path: {world.ARCH} heads {world.REAL_CLASS_COUNTS}, engine "
        f"built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(world.SEED + 1)
    images = rng.integers(0, 256, (8, 256, 256, 3), dtype=np.uint8)

    # the default configuration: the stride-1 kernel only
    preds, (default_launches, _) = _drive("fast", fast, images, WANT_DEFAULT)
    module = engine(fast=False)
    x = torch.as_tensor(images, device="cuda")
    _hold_to_module("fast", fast, module, x)
    ref_preds = module.predict_batch(images)
    same = {k: float(np.mean(preds[k][0] == ref_preds[k][0])) for k in preds}
    log(f"main path: predicted-class agreement fast vs module {same}")

    # the card's run against the plain version on the CPU, one image
    cpu = engine("cpu", fast=True, use_pallas=True)
    cpu_logits = cpu.crop_logits(torch.as_tensor(images[:1]))
    for g, r in zip(fast.crop_logits(x[:1]), cpu_logits):
        if not torch.allclose(g.cpu(), r, rtol=FAST_RTOL, atol=FAST_ATOL):
            raise RuntimeError("card and CPU fast paths disagree: max_abs_err "
                               f"{float((g.cpu() - r).abs().max())}")
    log("main path: card vs CPU plain version, 1 image x 10 crops: max_abs_err "
        + ", ".join(f"{float((g.cpu() - r).abs().max()):.4f}" for g, r in
                    zip(fast.crop_logits(x[:1]), cpu_logits)))

    # the use_pallas_s2 configuration: layer2.0 through the stride-2 kernel
    fast_s2 = engine(fast=True, use_pallas=True, use_pallas_s2=True)
    preds_s2, (_, s2_launches) = _drive("fast_s2", fast_s2, images, WANT_S2)
    _hold_to_module("fast_s2", fast_s2, module, x)
    same = {k: float(np.mean(preds_s2[k][0] == ref_preds[k][0]))
            for k in preds_s2}
    log(f"main path: predicted-class agreement fast_s2 vs module {same}")

    # end to end: both kernel configurations, the same folded path on cuDNN
    # convolutions only (yardstick), and the unfolded module path
    folded_cudnn = engine(fast=True, use_pallas=False)
    batch = rng.integers(0, 256, (64, 256, 256, 3), dtype=np.uint8)
    fast_ips, per_fwd = _counted(lambda: _images_per_s(fast, batch))
    s2_ips, per_fwd_s2 = _counted(lambda: _images_per_s(fast_s2, batch))
    module_ips = _images_per_s(module, batch)
    cudnn_ips = _images_per_s(folded_cudnn, batch)
    per_fwd = tuple(c / 6 for c in per_fwd)
    per_fwd_s2 = tuple(c / 6 for c in per_fwd_s2)
    log("main path throughput " + json.dumps({
        "metric": "predict_batch ten-crop images/s", "batch": 64,
        "fast_pallas": fast_ips, "fast_pallas_s2": s2_ips,
        "fast_cudnn_only": cudnn_ips, "module_path": module_ips,
        "launches_per_forward_fast": per_fwd,
        "launches_per_forward_fast_s2": per_fwd_s2,
        "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
        "card": label}))
    if per_fwd != WANT_DEFAULT or per_fwd_s2 != WANT_S2:
        raise RuntimeError(f"launches per forward {per_fwd} and "
                           f"{per_fwd_s2}, want {WANT_DEFAULT} and {WANT_S2}")
    return {"fused_bottleneck": default_launches,
            "fused_bottleneck_s2": s2_launches}, fast, module, fast_ips


# -- phase 4 -------------------------------------------------------------------

def _pillow():
    """PIL.Image, or None where Pillow is not installed (it is not a
    dependency of the port's device path)."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def _jpeg(image_mod, array):
    buf = io.BytesIO()
    image_mod.fromarray(array).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def phase_host_exact(engine, module):
    """`tta_mode="host_exact"` on the fast path: the stride-1 kernel's
    launches in one `predict_batch` of exact host ten-crops, and the per-crop
    logits against the module path's on the same crops."""
    fast = engine(fast=True, use_pallas=True, tta_mode="host_exact")
    rng = np.random.default_rng(world.SEED + 2)
    image_mod = _pillow()
    if image_mod is not None:
        sizes = [(333, 250), (250, 333), (480, 300), (300, 457), (640, 427),
                 (427, 640), (257, 700), (900, 261)]          # (w, h)
        blobs = [_jpeg(image_mod, rng.integers(0, 256, (h, w, 3), np.uint8))
                 for w, h in sizes]
        crops, ok = decode.decode_batch_tencrop(blobs)
        if not ok.all():
            raise RuntimeError(f"decode_batch_tencrop failed on {ok}")
        source = "decode_batch_tencrop of 8 seeded non-square JPEGs"
    else:
        crops = rng.integers(0, 256, (8, 10, 224, 224, 3), np.uint8)
        source = "8 x 10 seeded uint8 crops (Pillow is not installed)"
    preds, launches = _drive("host_exact", fast, crops, WANT_DEFAULT)
    log(f"host exact: {source}, {crops.shape} uint8")
    x = torch.as_tensor(crops, device="cuda")
    _hold_to_module("host_exact", fast, module, x)
    ref = module.predict_batch(crops)
    same = {k: float(np.mean(preds[k][0] == ref[k][0])) for k in preds}
    log(f"host exact: predicted-class agreement fast vs module {same}")
    return crops


# -- phase 5 -------------------------------------------------------------------

N_REQUESTS, N_CLIENTS, SERVER_BATCH = 128, 64, 16


def _first_error(message):
    """The compiler's first error line of a failed build."""
    lines = message.splitlines()
    return next((line for line in lines if "error" in line), lines[-1])


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def _post(port, blob):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=blob, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())["predictions"]


def _burst(send, n, n_clients):
    """send(0..n-1) from n_clients threads -> (answers, seconds per
    request, wall seconds)."""
    answers, latency = [None] * n, [0.0] * n

    def client(k):
        for i in range(k, n, n_clients):
            t0 = time.perf_counter()
            answers[i] = send(i)
            latency[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return answers, latency, time.perf_counter() - t0


def _http_burst(port, blobs, n_clients):
    """The clients' side, run in a process of its own so that they do not
    compete with the server for the interpreter lock."""
    return _burst(lambda i: _post(port, blobs[i]), len(blobs), n_clients)


def phase_server(label, fast):
    """The server on the default fast path under a burst of clients.
    Returns its summary line."""
    srv = GeoInferenceServer(fast, port=0, batch_size=SERVER_BATCH,
                             max_wait_ms=5)
    srv.start_background()
    try:
        rng = np.random.default_rng(world.SEED + 3)
        image_mod = _pillow()
        if image_mod is not None:
            blobs = [_jpeg(image_mod, rng.integers(
                0, 256, (int(rng.integers(240, 600)),
                         int(rng.integers(240, 600)), 3), np.uint8))
                for _ in range(N_REQUESTS)]
            decoded = [srv._decode(b) for b in blobs]   # the server's decode
            if not all(ok[0] for _, ok in decoded):
                raise RuntimeError("the server's decoder refused a JPEG")
            images = np.stack([im[0] for im, _ in decoded])
            how = ("POST /predict of seeded JPEGs from a client process of "
                   "its own")
        else:
            images = rng.integers(0, 256, (N_REQUESTS, 256, 256, 3),
                                  np.uint8)
            how = ("MicroBatcher.submit of seeded uint8 arrays: Pillow is "
                   "not installed, so no JPEG can be made")
        native = ("built" if decode.native.available() else "not built: "
                  + _first_error(decode.native.build_error()))
        log(f"server: {how}; decode backend {decode.auto_backend()!r}; "
            f"native ingest library {native}")
        fast.predict_batch(images[:SERVER_BATCH])   # the --warmup batch
        ops.fused_bottleneck.launches = ops.fused_bottleneck_s2.launches = 0
        if image_mod is not None:
            with multiprocessing.get_context("spawn").Pool(1) as pool:
                answers, latency, wall = pool.apply(
                    _http_burst, (srv.port, blobs, N_CLIENTS))
        else:
            answers, latency, wall = _burst(
                lambda i: srv.batcher.submit(images[i]), N_REQUESTS,
                N_CLIENTS)
        launches = (ops.fused_bottleneck.launches,
                    ops.fused_bottleneck_s2.launches)
        stats = srv.batcher.stats()
        if None in answers or stats["requests"] != N_REQUESTS:
            raise RuntimeError(f"server answered {stats['requests']} of "
                               f"{N_REQUESTS} requests")
        want = (WANT_DEFAULT[0] * stats["batches"], 0)
        log(f"server: {stats['batches']} micro-batches, launches "
            f"fused_bottleneck {launches[0]}, fused_bottleneck_s2 "
            f"{launches[1]} (want {want})")
        if launches != want:
            raise RuntimeError(f"server: launches {launches}, want {want}")

        # every answer against predict_batch on the same decoded images, in
        # batches of the server's size (the same shapes on the card)
        for start in range(0, N_REQUESTS, SERVER_BATCH):
            ref = fast.predict_batch(images[start:start + SERVER_BATCH])
            for j, answer in enumerate(answers[start:start + SERVER_BATCH]):
                want_answer = {k: {"class": int(cls[j]), "lat": float(lat[j]),
                                   "lng": float(lng[j])}
                               for k, (cls, lat, lng) in ref.items()}
                if answer != want_answer:
                    raise RuntimeError(
                        f"server answer {start + j} differs from "
                        f"predict_batch: {answer} != {want_answer}")
        health, served = _get(srv.port, "/healthz"), _get(srv.port, "/stats")
        if health["status"] != "ok" or served["requests"] != N_REQUESTS:
            raise RuntimeError(f"/healthz {health}, /stats {served}")
        log(f"server: /healthz {health}; /stats {served}")
    finally:
        srv.close()
    ms = 1e3 * np.asarray(latency)
    return {"metric": "server requests/s", "requests": N_REQUESTS,
            "clients": N_CLIENTS, "batch_size": SERVER_BATCH,
            "max_wait_ms": 5, "requests_per_s": N_REQUESTS / wall,
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "mean_occupancy": stats["mean_occupancy"],
            "batches": stats["batches"],
            "predict_batch_share": stats["predict_s"] / wall, "how": how,
            "decode_backend": decode.auto_backend(),
            "launches_fused_bottleneck": launches[0], "card": label}


# -- phase 6 -------------------------------------------------------------------

INT8_MIN_CORR = 0.98     # per head, as tests/test_quant.py:196


def _int8_launches(fn):
    """(fn(), conv_s8 launches during it), the count set to 0 just before."""
    ops8.conv_s8.launches = 0
    out = fn()
    return out, ops8.conv_s8.launches


def _corr(g, r):
    """Correlation of two logits arrays, each centered on its mean (as
    tests/test_quant.py:196)."""
    g, r = g.double().cpu().numpy(), r.double().cpu().numpy()
    gc, rc = g - g.mean(), r - r.mean()
    return float((gc * rc).sum() / (np.linalg.norm(gc) * np.linalg.norm(rc)
                                    + 1e-12))


def _int8_checks(name, eng, fp32, x, crops_s8, n_images, feature_tta=None,
                 rows=None):
    """One predict_batch of an int8 engine with the count set to 0 just
    before: 53 launches; per-crop logits equal to the plain int8 network's
    on the same scales (`feature_tta` its feature-TTA form, fed the base
    images `crops_s8`), the predicted classes too; unless `fp32` is None,
    per-crop logits correlated with the float32 module path's, over the
    crops `rows` (all by default). Returns the launches."""
    preds, launches = _int8_launches(lambda: eng.predict_batch(
        x.cpu().numpy()))
    log(f"int8: {name} predict_batch({n_images} images x {eng.n_crops} "
        f"crops): conv_s8 launches {launches} (want {INT8_LAUNCHES})")
    if launches != INT8_LAUNCHES:
        raise RuntimeError(f"int8 {name}: {launches} conv_s8 launches in one "
                           f"forward, want {INT8_LAUNCHES}")
    _check_predictions(eng, preds, n_images)
    plain = quant.build_int8_apply(eng._qnet, eng.int8_scales,
                                   n_classes=eng._n_classes,
                                   feature_tta=feature_tta, device="cuda",
                                   plain=True)
    got, ref = eng.crop_logits(x), plain(crops_s8)
    for head, g, r in zip(eng.pred_keys, got, ref):
        if not torch.equal(g, r):
            raise RuntimeError(
                f"int8 {name}: logits differ from the plain int8 network on "
                f"head {head}: max_abs_err {float((g - r).abs().max())}")
    plain_preds = predict_all(
        [mean_tta_logits(r, eng.n_crops, fold=eng.tta_fold) for r in ref],
        eng.harrays)
    for key, (cls, _, _) in preds.items():
        if not np.array_equal(cls, plain_preds[key][0].cpu().numpy()):
            raise RuntimeError(f"int8 {name}: classes differ from the plain "
                               f"int8 network's on {key}")
    if fp32 is None:
        return launches
    corrs = {}
    for head, g, r in zip(eng.pred_keys, got, fp32.crop_logits(x)):
        if rows is not None:
            g, r = g[rows], r[rows]
        corrs[head] = _corr(g, r)
        agree = float((g.argmax(-1) == r.argmax(-1)).float().mean())
        log(f"int8: {name} vs float32 module logits, head {g.shape[-1]} "
            f"classes, {len(g)} crops: correlation {corrs[head]:.6f}, "
            f"per-crop argmax agreement {agree:.4f}")
    if min(corrs.values()) < INT8_MIN_CORR:
        raise RuntimeError(f"int8 {name}: logit correlation {corrs} under "
                           f"{INT8_MIN_CORR}")
    return launches


def phase_int8(label, engine, fast_ips, host_crops):
    """The int8 serving path on the full-width world (module docs, 6);
    returns conv_s8's launches in the main path's forward."""
    rng = np.random.default_rng(world.SEED + 1)     # phase 3's images
    images = rng.integers(0, 256, (8, 256, 256, 3), dtype=np.uint8)
    batch = rng.integers(0, 256, (64, 256, 256, 3), dtype=np.uint8)
    x = torch.as_tensor(images, device="cuda")
    fp32 = engine(fast=False, dtype=torch.float32)
    t0 = time.perf_counter()
    int8 = engine(int8=True)
    int8.predict_batch(images)                      # calibrates: auto
    log(f"int8: built and calibrated on its first batch in "
        f"{time.perf_counter() - t0:.1f} s: source "
        f"{int8.int8_calib_source}, stat {int8.int8_calib_stat}, KL "
        f"{json.dumps(int8.int8_calib_kls)}")
    launches = _int8_checks("device ten-crop", int8, fp32, x,
                            eval_pipeline_s8(x), len(images))
    int8_ips, n = _int8_launches(lambda: _images_per_s(int8, batch))
    log("int8 throughput " + json.dumps({
        "metric": "predict_batch ten-crop images/s", "batch": 64,
        "int8": int8_ips, "bf16_fast_pallas_phase3": fast_ips,
        "launches_per_forward": n / 6,
        "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
        "card": label}))
    if n != 6 * INT8_LAUNCHES:
        raise RuntimeError(f"int8: {n} conv_s8 launches in 6 forwards")

    # --exact_tta --precision 8: phase 4's host ten-crops, 5-D batches
    exact = engine(int8=True, tta_mode="host_exact")
    exact.predict_batch(host_crops)                 # calibrates on 5-D
    log(f"int8 host exact: calibrated on host crops {host_crops.shape}: "
        f"stat {exact.int8_calib_stat}")
    hx = torch.as_tensor(host_crops, device="cuda")
    _int8_checks("host_exact", exact,
                 engine(fast=False, dtype=torch.float32,
                        tta_mode="host_exact"),
                 hx, shift_s8(hx.reshape((-1,) + hx.shape[-3:])),
                 len(host_crops))
    return launches


# -- phase 7 -------------------------------------------------------------------

# The kernels' new shapes on the TTA variants, for 8 base images of 256 px:
# feature TTA runs the stem, layer1 (64 wide) and layer2 (32 wide) once on
# the bases and their mirrors (N = 16); mirror TTA and ISN meet the main
# path's shapes. The stride-2 kernel meets the 64-wide layer2 entry only
# under use_pallas_s2, which no CLI sets.
FTTA_N = 16
TTA_SHAPES = {
    "fused_bottleneck": [
        ("ftta layer1.0 64x64 64-64-256 proj", FTTA_N, 64, 64, 64, 64, 256,
         True, 1),
        ("ftta layer1.1-2 64x64 256-64-256", FTTA_N, 64, 64, 256, 64, 256,
         False, 2),
        ("ftta layer2.1-3 32x32 512-128-512", FTTA_N, 32, 32, 512, 128, 512,
         False, 3),
    ],
    "fused_bottleneck_s2": [
        ("ftta layer2.0 64x64 256-128-512 (use_pallas_s2)", FTTA_N, 64, 64,
         256, 128, 512, True, 0),
    ],
}
WANT_MIRROR = (12, 0)     # net and netM, each the default path's 6
FTTA_LEVELS = ((3, 8), (1, 4), (2, 4))    # (level, images): level 3 first


def ftta_conv_shapes(n=FTTA_N):
    """The int8 feature-TTA trunk's convolutions on 256-px bases (the stem
    over a 132-wide space-to-depth buffer, layer1 at 64, layer2 at 64 and
    32, layer3 at 32 and 16) with their launches per forward; layer4 runs
    per window at the main path's shapes."""
    return [s for s in int8_conv_shapes(n, crop=256)
            if not s[0].startswith("layer4")]


def _same_answers(name, eng, preds, logits):
    """predict_batch's classes are those of the per-crop logits, folded."""
    want = predict_all([mean_tta_logits(l, eng.n_crops, fold=eng.tta_fold)
                        for l in logits], eng.harrays)
    for key, (cls, _, _) in preds.items():
        if not np.array_equal(cls, want[key][0].cpu().numpy()):
            raise RuntimeError(f"{name}: predict_batch's classes differ from "
                               f"its folded crop logits on {key}")


def _feature_tta(label, engine, images, cache):
    """Feature TTA at each level through `InferenceEngine`: bf16 on the
    kernels (6 launches a forward, logits within the fast-path gates of the
    cuDNN route at the same level) and int8 (53 launches, logits equal to
    the plain int8 network's; calibrated at level 3, then through the scales
    cache). Returns (launches, the level-3 engines)."""
    x = torch.as_tensor(images, device="cuda")
    launches, engines = {}, {}
    for level, n in FTTA_LEVELS:
        kw = dict(tta_mode="feature", feature_tta_level=level)
        fast = engine(fast=True, use_pallas=True, **kw)
        name = f"feature TTA level {level}"
        preds, launches[level] = _drive(name, fast, images[:n], WANT_DEFAULT)
        logits = fast.crop_logits(x[:n])
        _same_answers(name, fast, preds, logits)
        _hold_logits(f"tta: {name} kernels vs cuDNN route", fast.pred_keys,
                     logits, engine(fast=True, use_pallas=False,
                                    **kw).crop_logits(x[:n]), 10 * n)
        int8 = engine(int8=True, int8_scales_path=cache, **kw)
        int8.predict_batch(images[:n])       # calibrates, or reads the cache
        log(f"tta: int8 {name}: scales from {int8.int8_calib_source}, stat "
            f"{int8.int8_calib_stat}")
        launches[f"int8 {level}"] = _int8_checks(
            f"feature TTA level {level}", int8, None, x[:n], shift_s8(x[:n]),
            n, feature_tta={"crop": 224, "n_crops": 10, "level": level})
        if level == 3:
            engines = {"fast": fast, "int8": int8}
    return launches, engines


def phase_tta(label, engine, fast, sd, ptxas, fast_ips):
    """The TTA variants (module docs, 7); returns each kernel's launches
    per forward on them."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    sums = [check_kernel(name, label, gen, shapes)
            for name, shapes in TTA_SHAPES.items()]
    sums.append(check_conv_s8(label, gen, ptxas.get("conv_s8"),
                              ftta_conv_shapes()))
    sums = [e for e in sums if e["ms"]]     # the kernels feature TTA runs
    log("tta kernel sums " + json.dumps({
        "what": "new shapes of feature TTA's trunk, summed over its launches "
                f"per forward of 8 base images (N = {FTTA_N})",
        "kernels": [{k: e[k] for k in ("name", "max_abs_err", "ms",
                                       "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")} for e in sums],
        "card": label}))
    rng = np.random.default_rng(world.SEED + 1)     # phase 3's images
    images = rng.integers(0, 256, (8, 256, 256, 3), dtype=np.uint8)
    batch = rng.integers(0, 256, (64, 256, 256, 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        launches, ftta = _feature_tta(label, engine, images,
                                      os.path.join(tmp, "int8_scales.json"))
        device_preds = fast.predict_batch(images)
        same = {k: float(np.mean(device_preds[k][0]
                                 == ftta["fast"].predict_batch(images)[k][0]))
                for k in device_preds}
        log(f"tta: predicted-class agreement feature TTA level 3 vs device "
            f"ten-crop {same}")
        ftta_ips, n_fast = _counted(lambda: _images_per_s(ftta["fast"], batch))
        int8_ips, n_int8 = _int8_launches(
            lambda: _images_per_s(ftta["int8"], batch))

    # mirror TTA: five crops through net and netM
    x = torch.as_tensor(images, device="cuda")
    kw = dict(n_classes=world.REAL_CLASS_COUNTS, device="cuda")
    mirror = build_mirror_tta_apply(sd, world.ARCH, **kw)
    got, launches["mirror"] = _counted(lambda: mirror(x))
    log(f"tta: mirror TTA (8 images x 5 crops x {{net, netM}}): launches "
        f"fused_bottleneck {launches['mirror'][0]}, fused_bottleneck_s2 "
        f"{launches['mirror'][1]} (want {WANT_MIRROR})")
    if launches["mirror"] != WANT_MIRROR:
        raise RuntimeError(f"mirror TTA: launches {launches['mirror']}, want "
                           f"{WANT_MIRROR}")
    _hold_logits("tta: mirror TTA vs device ten-crop fast path",
                 fast.pred_keys, got, fast.crop_logits(x), 80)
    crops = eval_pipeline(x, n_crops=5)
    net, net_m = (build_fast_apply(sd, world.ARCH, mirror=m, **kw)
                  for m in (False, True))
    pooled = []
    for apply, v in ((net_m, crops), (net, crops.flip(2))):
        for fn in apply.stage_fns:
            v = fn(v)
        pooled.append(v.mean(dim=(2, 3), dtype=torch.float32))
    _hold_logits("tta: netM(crop) vs net(flip(crop)) pooled features",
                 ["features"], pooled[:1], pooled[1:], 40, rtol=KERNEL_RTOL,
                 atol=KERNEL_ATOL)
    harrays = fast.harrays
    xb = torch.as_tensor(batch, device="cuda")
    device_ms = time_ms(lambda: world.forward(fast._fast_apply, harrays)(xb),
                        reps=10)
    mirror_ms = time_ms(lambda: predict_all(
        [mean_tta_logits(l, 10) for l in mirror(xb)], harrays), reps=10)
    log("tta throughput " + json.dumps({
        "metric": "ten-crop images/s", "batch": 64,
        "predict_batch": {"feature_tta_l3_bf16": ftta_ips,
                          "feature_tta_l3_int8": int8_ips,
                          "device_tta_bf16_phase3": fast_ips},
        "device_forward": {"mirror_tta_bf16": 64e3 / mirror_ms,
                           "device_tta_bf16": 64e3 / device_ms},
        "launches_per_forward": {"feature_bf16": [c / 6 for c in n_fast],
                                 "feature_int8": n_int8 / 6},
        "card": label}))
    if tuple(c / 6 for c in n_fast) != WANT_DEFAULT or n_int8 != 6 * \
            INT8_LAUNCHES:
        raise RuntimeError(f"feature TTA: launches {n_fast}, {n_int8} in 6 "
                           "forwards")
    return launches


# -- phase 8 -------------------------------------------------------------------

def _scene_logits(model, x, dtype):
    return model.with_scene(eval_pipeline(x, dtype=dtype))[0]


def _decisive(scene_logits):
    """Crops whose top-two scene margin exceeds the fast path's logit gate
    at the top logit: their route must not depend on the path."""
    top = scene_logits.topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]) > FAST_ATOL + FAST_RTOL * top[:, 0].abs()


def phase_isn(label):
    """ISN (module docs, 8); returns each kernel's launches on it."""
    config, sd, parts = world.build_world(n_scenes=3)

    def engine(**kw):
        return InferenceEngine(config, sd, partitionings=parts, n_crops=10,
                               device="cuda", **kw)

    rng = np.random.default_rng(world.SEED + 4)
    probe = torch.as_tensor(world.scene_images(rng, 12), device="cuda")
    fp32 = engine(dtype=torch.float32)
    with torch.inference_mode():
        feats = fp32.model.features(eval_pipeline(probe,
                                                  dtype=torch.float32))
    world.fit_scene_head(sd, feats, torch.arange(120) // 10 % 3)
    del fp32, feats
    log("isn: world with scene head fit to 12 probe images of 3 families; "
        f"heads {world.REAL_CLASS_COUNTS} x 3 scenes = "
        f"{sd['scene_geo_heads.weight'].shape[0]} outputs")
    images = world.scene_images(rng, 8)
    x = torch.as_tensor(images, device="cuda")
    module, fp32 = engine(), engine(dtype=torch.float32)
    fast = engine(fast=True, use_pallas=True)
    with torch.inference_mode():
        scene_bf16 = _scene_logits(module.model, x, torch.bfloat16)
        scene_fp32 = _scene_logits(fp32.model, x, torch.float32)
    routes = torch.bincount(scene_bf16.argmax(-1), minlength=3).tolist()
    log(f"isn: module path routes crops to scenes {routes} (80 crops)")
    if min(routes) == 0:
        raise RuntimeError(f"isn: a scene is never routed to: {routes}")
    rows = _decisive(scene_bf16)
    preds, (n_fast, _) = _drive("isn fast", fast, images, WANT_DEFAULT)
    _same_answers("isn fast", fast, preds, fast.crop_logits(x))
    _hold_logits("isn: fast vs module path on decisive crops",
                 fast.pred_keys, fast.crop_logits(x), module.crop_logits(x),
                 80, rows=rows)
    int8 = engine(int8=True)
    int8.predict_batch(images)                      # calibrates: auto
    log(f"isn: int8 calibrated on its first batch: stat "
        f"{int8.int8_calib_stat}, KL {json.dumps(int8.int8_calib_kls)}")
    n_int8 = _int8_checks("isn", int8, fp32, x, eval_pipeline_s8(x), 8,
                          rows=_decisive(scene_fp32))
    batch = world.scene_images(rng, 64)
    ips = {}
    for name, eng in (("module_bf16", module), ("fast_pallas", fast),
                      ("int8", int8)):
        ips[name] = _images_per_s(eng, batch)
    log("isn throughput " + json.dumps({
        "metric": "predict_batch ten-crop images/s", "batch": 64, **ips,
        "decisive_crops": {"bf16": int(rows.sum()),
                           "fp32": int(_decisive(scene_fp32).sum())},
        "card": label}))
    return {"fused_bottleneck": n_fast, "conv_s8": n_int8}


# -- phase 9 -------------------------------------------------------------------

TRAIN_STEPS = 12
TRAIN_BATCH = 256
OVERFIT_BATCH = 64
BN_RTOL, BN_ATOL = 1e-3, 1e-5   # fast against two-pass float32 variance


class _Stamped(io.TextIOBase):
    """Stdout that also keeps each line with the time it was written."""

    def __init__(self, out):
        self.out, self.lines, self._buf = out, [], ""

    def write(self, text):
        self.out.write(text)
        self._buf += text
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return len(text)

    def flush(self):
        self.out.flush()


def _all_launches():
    return (ops.fused_bottleneck.launches, ops.fused_bottleneck_s2.launches,
            ops8.conv_s8.launches)


def _fit(label, path):
    """train_base.main on the world at `path`; returns the trainer and the
    kernels' launches during it. The host's wait for batches is reported
    against the wall from the start of main to the last step."""
    ops.fused_bottleneck.launches = ops.fused_bottleneck_s2.launches = 0
    ops8.conv_s8.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = _Stamped(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        trainer = train_base.main(["--config", path, "--max_steps",
                                   str(TRAIN_STEPS), "--no_resume"])
    wall = time.perf_counter() - t0
    launches = _all_launches()
    steps, after_epoch_end = [], set()
    for t, line in out.lines:
        if line.startswith("step "):
            head = line.split()
            steps.append((int(head[1].split("/")[0]), t, float(head[3])))
        elif line.startswith(("epoch end @", "val @")) and steps:
            after_epoch_end.add(steps[-1][0] + 1)
    losses = [loss for _, _, loss in steps]
    if [k for k, _, _ in steps] != list(range(1, TRAIN_STEPS + 1)) or \
            not all(np.isfinite(losses)):
        raise RuntimeError(f"train: steps {[k for k, _, _ in steps]}, "
                           f"losses {losses}")
    # steps 3..12, leaving out the intervals that hold a validation and a
    # checkpoint
    dts = [t - steps[i - 1][1] for i, (k, t, _) in enumerate(steps)
           if k >= 3 and k not in after_epoch_end]
    line = {
        "metric": "Trainer.fit via train_base.main", "steps": TRAIN_STEPS,
        "batch": TRAIN_BATCH, "losses": losses,
        "images_per_s_after_step_2": TRAIN_BATCH / float(np.mean(dts)),
        "ms_per_step_after_step_2": 1e3 * float(np.mean(dts)),
        "steps_timed": len(dts),
        "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
        "batch_wait_s": trainer.batch_wait_s,
        "batch_wait_share": trainer.batch_wait_s / (steps[-1][1] - t0),
        "wall_s": wall, "card": label}
    log("train fit " + json.dumps(line))
    if launches != (0, 0, 0):
        raise RuntimeError(f"train: the train steps launched kernels "
                           f"{launches}")
    return trainer, launches


def _bn_checked_step(state, step):
    """One more bench step with each BatchNorm's input measured plainly: the
    loss finite; every parameter p_before - lr * trace, the update the
    optimizer computed (SGD, no weight decay), and some changed; the running
    statistics 0.9 * old + 0.1 * (float32 mean, biased two-pass
    variance)."""
    model = state.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    old = {id(m): (m.running_mean.clone(), m.running_var.clone())
           for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)}
    seen = []
    plain = resnet.batch_norm_train

    def recording(x, bn):
        var, mean = torch.var_mean(x.detach().float(), dim=(0, 2, 3),
                                   unbiased=False)
        seen.append((bn, mean, var))
        return plain(x, bn)

    resnet.batch_norm_train = recording
    try:
        metrics = step()
    finally:
        resnet.batch_norm_train = plain
    loss = float(metrics["loss"])
    opt = state.optimizer
    lr = opt.schedule(opt.count - 1)
    params = list(model.named_parameters())
    off = [n for (n, p), t in zip(params, opt.slots["trace"])
           if not torch.equal(p, before[n] - lr * t)]
    changed = sum(not torch.equal(p, before[n]) for n, p in params)
    worst = 0.0
    for bn, mean, var in seen:
        old_mean, old_var = old[id(bn)]
        for got, want in ((bn.running_mean, 0.9 * old_mean + 0.1 * mean),
                          (bn.running_var, 0.9 * old_var + 0.1 * var)):
            err = ((got - want).abs() / (BN_ATOL + BN_RTOL * want.abs()))
            worst = max(worst, float(err.max()))
    log(f"train: bench step checks: loss {loss:.4f}; {len(params)} "
        f"parameters, {len(params) - len(off)} updated as the optimizer "
        f"computed, {changed} changed (an update under half a float32 ulp "
        f"leaves a value as it was); {len(seen)} BatchNorms held to a plain "
        f"float32 recomputation (worst at {worst:.4f} of rtol {BN_RTOL}, "
        f"atol {BN_ATOL})")
    if not np.isfinite(loss) or off or not changed or worst > 1 or \
            len(seen) != len(old):
        raise RuntimeError(f"train: bench step: loss {loss}, not updated "
                           f"{off[:5]}, changed {changed}, BatchNorms "
                           f"{len(seen)} of {len(old)}, worst {worst}")


def _profile(label, step, step_ms):
    """Device time by operator over two bench steps (torch.profiler; each
    kernel counted once, under the operator that launched it), and the
    device's busy share of an unprofiled step of `step_ms`."""
    kind = torch.autograd.DeviceType
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == kind.CUDA) / 2e3
    by_op = sorted((e for e in events if e.device_type == kind.CPU
                    and e.self_device_time_total > 0),
                   key=lambda e: e.self_device_time_total, reverse=True)
    log("train profile " + json.dumps({
        "what": "bench_train step at batch 256, device ms a step by "
                "operator (its kernels' self time, mean of two steps)",
        "device_busy_ms_per_step": busy_ms, "step_ms": step_ms,
        "device_busy_share": busy_ms / step_ms,
        "top": {e.key: e.self_device_time_total / 2e3 for e in by_op[:14]},
        "card": label}))


def _bench(label):
    """bench_train at batch 256 with and without remat; the checks of
    `_bn_checked_step` on the plain one."""
    out = {}
    for remat in (False, True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, _, _, step = bench_train.setup(TRAIN_BATCH, remat=remat)
        ms, metrics = bench_train.measure(step, 10, torch.device("cuda"))
        out["remat" if remat else "plain"] = {
            "ms_per_step": ms, "images_per_s": TRAIN_BATCH * 1e3 / ms,
            "loss": float(metrics["loss"]),
            "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2 ** 30}
        if not remat:
            _bn_checked_step(state, step)
            _profile(label, step, ms)
        del state, step
    log("train bench " + json.dumps({
        "metric": "bench_train ResNet50 bf16 train step", "batch":
        TRAIN_BATCH, "iters": 10, **out, "card": label}))


def _overfit():
    """25 steps on one fixed batch of 64 center crops (augment=False), SGD
    lr 0.05 momentum 0.9 as tests/test_train.py: the last loss under half
    the first."""
    state, images, labels, _ = bench_train.setup(OVERFIT_BATCH, seed=1)
    state.optimizer = Optimizer(state.model.parameters(),
                                constant_schedule(0.05), momentum=0.9)
    losses = []
    for _ in range(25):
        _, metrics = train_step(state, images, labels, 0, augment=False)
        losses.append(float(metrics["loss"]))
    log(f"train: overfit on one batch of {OVERFIT_BATCH}: losses "
        f"{[round(x, 4) for x in losses]}")
    if not losses[-1] < 0.5 * losses[0]:
        raise RuntimeError(f"train: overfit: last loss {losses[-1]} not "
                           f"under half the first {losses[0]}")


def _serve_trained(ckpt, val_pattern):
    """The best checkpoint on the default fast path against the module
    path, on 8 validation images; returns fused_bottleneck's launches."""
    config, sd = load_checkpoint(ckpt)
    recs = list(shards.iter_records([val_pattern]))[:8]
    images, ok = decode.decode_batch([r["image"] for r in recs])
    assert ok.all()

    def engine(**kw):
        return InferenceEngine(config, sd, n_crops=10, device="cuda", **kw)

    fast, module = engine(fast=True, use_pallas=True), engine()
    preds, (launches, _) = _drive("train: trained checkpoint", fast, images,
                                  WANT_DEFAULT)
    x = torch.as_tensor(images, device="cuda")
    _hold_logits("train: trained checkpoint fast vs module logits",
                 fast.pred_keys, fast.crop_logits(x), module.crop_logits(x),
                 10 * len(images))
    ref = module.predict_batch(images)
    for key, (cls, _, _) in preds.items():
        if not np.array_equal(cls, ref[key][0]):
            raise RuntimeError(f"train: trained checkpoint: the fast path's "
                               f"classes differ from the module path's on "
                               f"{key}")
    log(f"train: trained checkpoint served: classes equal on "
        f"{sorted(preds)}")
    return launches


def _shard_world(tmp):
    """Phase 9's seeded shard world under `tmp`; its config's path."""
    parts = world.seeded_partitionings(np.random.default_rng(world.SEED + 5))
    config = load_config(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "configs", "baseM.yml"))
    config.train_params.log_every_steps = 1
    config.train_params.checkpoint_every_steps = 0
    t0 = time.perf_counter()
    path = world.write_shard_world(tmp, parts, config, train_shards=4,
                                   per_shard=384, n_val=64,
                                   sizes=(256, 320))
    log(f"train: shard world written in {time.perf_counter() - t0:.1f} "
        f"s: 4 x 384 training and 64 validation records, heads "
        f"{world.REAL_CLASS_COUNTS}")
    return path


def phase_train(label, tmp):
    """Training at baseM's full width (module docs, 9) on a shard world
    written under `tmp`; returns each kernel's launches during the train
    steps, fused_bottleneck's per forward of the trained checkpoint, and
    the world's config path."""
    torch.cuda.empty_cache()
    path = _shard_world(tmp)
    trainer, launches = _fit(label, path)
    ckpt = trainer.tp.checkpoint_dir
    log(f"train: checkpoints {trainer.ckpt.all_steps()}, best "
        f"{trainer.ckpt.best_step()}")
    del trainer
    _bench(label)
    _overfit()
    served = _serve_trained(ckpt, os.path.join(tmp, "val", "*.msgpack"))
    return launches, served, path


# -- phase 10 ------------------------------------------------------------------

MP_IMAGES, MP_BATCH = 64, 32     # the eval world: 32 images a rank
MP_TRAIN_STEPS = 6
MP_TIMEOUT_S = 300               # each group of ranks
# The two-process train gates against one process (bf16 on cuDNN, 128 rows
# a rank against 256): every step's loss (relative); the batch statistics
# of step 1 recovered from the running statistics, in units of each
# channel's standard deviation (mean) and variance (variance), worst
# channel; the heads' update over the run (the norm of the difference over
# the norm of one process's update; the trunk's groups and single
# parameters are printed, not gated: a clean pair reads 0.04 on the conv
# weights and 0.2 on a BatchNorm bias). Set from the readings of a clean
# pair and of pairs with a planted fault (`--planted-faults`, PERF.md).
MP_LOSS_RTOL, MP_BN_LIMIT, MP_UPDATE_RTOL = 6e-5, 5e-3, 8e-3
CLI = "geoestimation_tpu_torch.classification."


def _no_grad_allreduce(multihost):
    multihost.all_reduce_grads = lambda params: None


def _local_bn_statistics(multihost):
    multihost.sum_over_ranks = lambda t: t


def _bn_sums_without_gradient_sum(multihost):
    total = multihost.device_sum
    multihost.sum_over_ranks = lambda t: t + (total(t) - t).detach()


# what `--planted-faults` breaks in a training pair's rank processes: the
# gradient all-reduce; the BatchNorm sums over the ranks; their backward
FAULTS = {"no_grad_allreduce": _no_grad_allreduce,
          "local_bn_statistics": _local_bn_statistics,
          "bn_sums_without_gradient_sum": _bn_sums_without_gradient_sum}


def rank_main(report_path, module, argv, fault=None):
    """`python3 chip_smoke.py --rank REPORT [--fault NAME] MODULE ARGS...`:
    a process of phase 10. Runs the port CLI MODULE's main(ARGS) here and
    writes to REPORT what the phase reads: each forward's kernel launches,
    each image's predictions, the int8 calibration's identity, each train
    step's loss, wall, kernel launches and gradient all-reduce ms, the
    device group's backend and the peak memory. Rank 0 of a training run
    also saves step 1's batch statistics (recovered from the running
    statistics) to REPORT.bn.pt and each parameter's update over the run
    to REPORT.update.pt. `--fault` plants one of FAULTS first."""
    import hashlib
    import importlib

    from geoestimation_tpu_torch.data import image_folder
    from geoestimation_tpu_torch.parallel import multihost
    from geoestimation_tpu_torch.train import loop

    report = {"forwards": [], "images": {}, "steps": [], "backend": None}
    current, saved = {}, {}
    if fault is not None:
        FAULTS[fault](multihost)

    def running(state):
        return {k: v.detach().cpu().clone()
                for k, v in state.model.state_dict().items()
                if k.endswith(("running_mean", "running_var"))}

    def params(state):
        return {k: v.detach().float().cpu()
                for k, v in state.model.named_parameters()}

    def backend():
        rt = multihost.runtime()
        report["backend"] = rt.backend if rt is not None else None

    def wrap(owner, name, make):
        setattr(owner, name, make(getattr(owner, name)))

    def folder(orig):
        def iterate(*a, **k):
            for batch in orig(*a, **k):
                current["batch"] = batch
                yield batch
        return iterate

    def predict(orig):
        def predict_batch(self, images_u8):
            batch = current.get("batch")
            preds = orig(self, images_u8)
            if batch is not None and batch.images is images_u8:
                for j, (img, ok) in enumerate(zip(batch.ids, batch.valid)):
                    if ok:
                        report["images"][img] = {
                            k: [int(c[j]), float(la[j]), float(ln[j])]
                            for k, (c, la, ln) in preds.items()}
            return preds
        return predict_batch

    def forward(orig):
        def counted(self, *a, **k):
            backend()
            before = _all_launches()
            out = orig(self, *a, **k)
            report["forwards"].append(
                [x - y for x, y in zip(_all_launches(), before)])
            return out
        return counted

    def build_int8(orig):
        def recorded(self, images_u8):
            orig(self, images_u8)
            report["int8"] = {
                "calib_dir": self._calib_dir, "weights_hash": self._qhash,
                "source": self.int8_calib_source,
                "stat": self.int8_calib_stat,
                "scales_sha256": hashlib.sha256(json.dumps(
                    {k: float(v) for k, v in self.int8_scales.items()},
                    sort_keys=True).encode()).hexdigest()}
        return recorded

    def train_step(orig):
        def timed(state, *a, **k):
            backend()
            rank0 = multihost.process_index() == 0
            if rank0 and state.step == 0:
                saved["init"] = {k: v.clone()
                                 for k, v in params(state).items()}
                saved["running"] = running(state)
            torch.cuda.synchronize()
            t0, before = time.perf_counter(), _all_launches()
            state, metrics = orig(state, *a, **k)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            report["steps"].append({
                "loss": loss, "ms": 1e3 * (t1 - t0), "end": t1,
                "launches": [x - y for x, y in zip(_all_launches(), before)],
                "allreduce_ms": None})
            if rank0 and state.step == 1:
                m = resnet.BN_MOMENTUM
                torch.save({k: (v - m * saved["running"][k]) / (1 - m)
                            for k, v in running(state).items()},
                           report_path + ".bn.pt")
            saved["state"] = state
            return state, metrics
        return timed

    def all_reduce(orig):
        def timed(params):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            orig(params)
            torch.cuda.synchronize()
            report.setdefault("allreduce_ms", []).append(
                1e3 * (time.perf_counter() - t0))
        return timed

    wrap(image_folder, "iter_image_folder", folder)
    wrap(InferenceEngine, "predict_batch", predict)
    wrap(InferenceEngine, "_forward", forward)
    wrap(InferenceEngine, "_build_int8", build_int8)
    wrap(loop, "train_step", train_step)
    wrap(multihost, "all_reduce_grads", all_reduce)
    torch.cuda.reset_peak_memory_stats()
    importlib.import_module(module).main(argv)
    report["peak_mem_GiB"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if "init" in saved:
        torch.save({k: v - saved["init"][k]
                    for k, v in params(saved["state"]).items()},
                   report_path + ".update.pt")
    with open(report_path, "w") as f:
        json.dump(report, f)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Ranks:
    """Groups of `rank_main` processes; `close` kills what still runs."""

    def __init__(self, tmp):
        self.tmp, self.procs = tmp, []

    def start(self, name, cli, args, n=2, fault=None):
        """n processes of the port's CLI `cli` (with the coordinator flags
        of their ranks when n > 1), each with FAULTS[fault] planted if
        given."""
        coord = f"127.0.0.1:{_free_port()}"
        group = []
        for p in range(n):
            report = os.path.join(self.tmp, f"{name}.rank{p}.json")
            cmd = [sys.executable, os.path.abspath(__file__), "--rank",
                   report, *(["--fault", fault] if fault else []),
                   CLI + cli, *args]
            if n > 1:
                cmd += ["--coordinator", coord, "--num_processes", str(n),
                        "--process_id", str(p)]
            group.append((subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), report))
        self.procs += [proc for proc, _ in group]
        return name, group

    def wait(self, started, timeout=MP_TIMEOUT_S):
        """Each rank's report and output; fails if a rank failed or passed
        `timeout` s (and then kills the group)."""
        name, group = started
        deadline = time.perf_counter() + timeout
        outs = []
        for proc, _ in group:
            try:
                outs.append(proc.communicate(timeout=max(
                    1.0, deadline - time.perf_counter()))[0])
            except subprocess.TimeoutExpired:
                self.close()
                raise RuntimeError(f"multi-process {name}: a rank passed "
                                   f"the {timeout} s limit")
        for p, ((proc, _), out) in enumerate(zip(group, outs)):
            if proc.returncode != 0:
                raise RuntimeError(f"multi-process {name}: rank {p} exited "
                                   f"{proc.returncode}:\n{out[-3000:]}")
        reports = []
        for _, path in group:
            with open(path) as f:
                reports.append(json.load(f))
        return reports, outs

    def close(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _gcd_km(lat1, lng1, lat2, lng2):
    p1, p2 = np.radians(lat1), np.radians(lat2)
    h = (np.sin((p2 - p1) / 2) ** 2 + np.cos(p1) * np.cos(p2)
         * np.sin(np.radians(lng2 - lng1) / 2) ** 2)
    return 2 * 6371.0088 * np.arcsin(np.sqrt(np.clip(h, 0, 1)))


def _mp_print(what, line):
    print(json.dumps({"multi_process": {what: line}}), flush=True)


def _eval_world(tmp, config, sd, parts):
    """A port checkpoint of the world, MP_IMAGES seeded JPEGs and their meta
    CSV (each at a random fine cell's center); returns their paths and the
    truth."""
    import copy

    from geoestimation_tpu_torch.checkpoint import save_checkpoint

    config = copy.deepcopy(config)
    files = []
    for p in parts:
        files.append(os.path.join(tmp, "cells", f"{p.name}.csv"))
        p.to_csv(files[-1])
    config.model_params.partitionings.files = files
    config.model_params.partitionings.shortnames = [p.name for p in parts]
    ckpt = os.path.join(tmp, "mp_ckpt")
    save_checkpoint(ckpt, sd, config)
    images = os.path.join(tmp, "mp_images")
    os.makedirs(images)
    rng = np.random.default_rng(world.SEED + 7)
    image_mod, fine, truth = _pillow(), parts[-1], {}
    with open(os.path.join(tmp, "mp_meta.csv"), "w") as f:
        f.write("IMG_ID,LAT,LON\n")
        for i in range(MP_IMAGES):
            name = f"img_{i:03d}.jpg"
            side = int(rng.integers(256, 400))
            with open(os.path.join(images, name), "wb") as g:
                g.write(_jpeg(image_mod, rng.integers(
                    0, 256, (side, int(rng.integers(256, 400)), 3),
                    np.uint8)))
            c = int(rng.integers(len(fine)))
            truth[name] = (float(fine.lat[c]), float(fine.lng[c]))
            f.write(f"{name},{truth[name][0]},{truth[name][1]}\n")
    return ckpt, images, os.path.join(tmp, "mp_meta.csv"), truth


def _table_gate(name, merged, single, pair_reports, single_report, truth):
    """The merged table against one process's: each count (accuracy x
    images) equal or within one image; prints each image whose predictions
    differ between the runs, with its distances to the truth."""
    per_pair = {}
    for r in pair_reports:
        per_pair.update(r["images"])
    moved = []
    for img, preds in sorted(single_report["images"].items()):
        for key, (_, lat, lng) in preds.items():
            got = per_pair[img][key]
            if (got[1], got[2]) != (lat, lng):
                t = truth[img]
                moved.append({"image": img, "key": key,
                              "single_km": float(_gcd_km(t[0], t[1], lat,
                                                         lng)),
                              "two_process_km": float(_gcd_km(
                                  t[0], t[1], got[1], got[2]))})
    worst, cells = 0, 0
    for data, table in single.items():
        for key, accs in table.items():
            if key.startswith("_"):
                continue
            for th, acc in accs.items():
                diff = abs(round(merged[data][key][th] * MP_IMAGES)
                           - round(acc * MP_IMAGES))
                worst, cells = max(worst, diff), cells + 1
    if set(per_pair) != set(single_report["images"]) or worst > 1:
        raise RuntimeError(f"multi-process {name}: tables differ by up to "
                           f"{worst} images ({len(per_pair)} images scored); "
                           f"moved {moved}")
    return {"table_cells": cells, "worst_count_diff_images": worst,
            "moved_images": moved}


def _launch_gate(name, reports, kernel, want):
    """Every forward of every rank launched `kernel` `want` times and the
    other kernels not at all; returns the launches per forward per rank."""
    k = {"fused_bottleneck": 0, "fused_bottleneck_s2": 1, "conv_s8": 2}[
        kernel]
    per_rank = []
    for p, r in enumerate(reports):
        fwd = r["forwards"]
        if not fwd or any(f[k] != want or sum(f) != want for f in fwd):
            raise RuntimeError(f"multi-process {name}: rank {p} launches per "
                               f"forward {fwd}, want {want} of {kernel}")
        per_rank.append(fwd[0][k])
    return per_rank


def _mp_eval(label, ranks, tmp, config, sd, parts):
    """Two-process test and inference CLIs (bf16) and int8 test CLI against
    one process each."""
    import pandas as pd

    ckpt, images, meta, truth = _eval_world(tmp, config, sd, parts)
    common = ["--checkpoint", ckpt, "--batch_size", str(MP_BATCH)]
    test = common + ["--image_dirs", images, "--meta_files", meta]
    int8 = ["--precision", "8", "--recalibrate"]
    out = {k: os.path.join(tmp, f"mp_{k}") for k in
           ("table", "table1", "int8", "int8_1", "preds", "preds1")}
    t0 = time.perf_counter()
    started = [
        ranks.start("test", "test", test + ["--fast", "--json",
                                             out["table"]]),
        ranks.start("test1", "test", test + ["--fast", "--json",
                                              out["table1"]], n=1),
        ranks.start("inference", "inference", common + [
            "--image_dir", images, "--fast", "--pallas", "--output",
            out["preds"]]),
        ranks.start("inference1", "inference", common + [
            "--image_dir", images, "--fast", "--pallas", "--output",
            out["preds1"]], n=1),
        ranks.start("int8", "test", test + int8 + ["--json", out["int8"]]),
        ranks.start("int8_1", "test", test + int8 + [
            "--calib_dir", images, "--json", out["int8_1"]], n=1),
    ]
    (tst, tst1, inf, inf1, i8, i81) = [
        ranks.wait(s)[0] for s in started]
    wall = time.perf_counter() - t0
    with open(out["table"]) as f:
        merged = json.load(f)
    with open(out["table1"]) as f:
        single = json.load(f)
    table = _table_gate("bf16 test", merged, single, tst, tst1[0], truth)
    # inference: the part files hold the single CSV's rows and classes
    parts_df = pd.concat([pd.read_csv(f"{out['preds']}.part-{p}-of-2")
                          for p in range(2)])
    key = ["img_id", "p_key"]
    got = parts_df.sort_values(key).reset_index(drop=True)
    want = pd.read_csv(out["preds1"]).sort_values(key).reset_index(drop=True)
    if not (got[key].equals(want[key])
            and got.pred_class.equals(want.pred_class)):
        raise RuntimeError("multi-process inference: the part files' rows "
                           "or classes differ from one process's")
    launches = _launch_gate("inference", inf, "fused_bottleneck",
                            WANT_DEFAULT[0])
    # int8: both ranks defaulted --calib_dir and derived the same scales
    ident = [r["int8"] for r in i8]
    if not (ident[0] == ident[1] and ident[0]["calib_dir"] == images
            and ident[0]["source"] == "calib_dir"
            and i81[0]["int8"]["scales_sha256"] == ident[0]["scales_sha256"]):
        raise RuntimeError(f"multi-process int8: calibrations {ident} and "
                           f"one process's {i81[0]['int8']}")
    with open(out["int8"]) as f:
        merged8 = json.load(f)
    with open(out["int8_1"]) as f:
        single8 = json.load(f)
    table8 = _table_gate("int8 test", merged8, single8, i8, i81[0], truth)
    launches8 = _launch_gate("int8", i8, "conv_s8", INT8_LAUNCHES)
    _mp_print("eval", {
        "what": "classification.test --fast (bf16, cuDNN route) in two "
                "processes on one card against one process, "
                f"{MP_IMAGES} images x 10 crops, batch {MP_BATCH}",
        **table, "inference_parts_equal_single": True,
        "inference_fused_bottleneck_per_forward_by_rank": launches,
        "forwards_by_rank": [len(r["forwards"]) for r in inf],
        "backend": tst[0]["backend"],
        "peak_mem_GiB_by_rank": [r["peak_mem_GiB"] for r in inf],
        "six_groups_wall_s": wall, "card": label})
    _mp_print("int8", {
        "what": "classification.test --precision 8 in two processes",
        "calib_dir_by_rank": [i["calib_dir"] for i in ident],
        "weights_hash_by_rank": [i["weights_hash"] for i in ident],
        "scales_sha256_by_rank": [i["scales_sha256"] for i in ident],
        "stat": ident[0]["stat"], **table8,
        "conv_s8_per_forward_by_rank": launches8, "card": label})
    return launches, launches8


def _train_figures(reports, batch):
    """Images/s from rank 0's step ends past step 1 (the loader's wait
    included) and from its steps alone."""
    steps = reports[0]["steps"]
    gaps = np.diff([s["end"] for s in steps])
    step_ms = [s["ms"] for s in steps[1:]]
    return {"images_per_s": batch / float(np.mean(gaps)),
            "images_per_s_steps_only": 1e3 * batch / float(np.mean(step_ms)),
            "ms_per_step": float(np.mean(step_ms))}


def _train_run(ranks, tmp, world_yml, name, n=2, fault=None):
    """train_base for MP_TRAIN_STEPS steps from the seed in n processes;
    each rank's report."""
    ckpt = os.path.join(tmp, f"ckpt_{name}")
    args = ["--config", world_yml, "--max_steps", str(MP_TRAIN_STEPS),
            "--no_resume", "--checkpoint_dir", ckpt]
    reports, _ = ranks.wait(ranks.start(name, "train_base", args, n=n,
                                        fault=fault))
    shutil.rmtree(ckpt)
    return reports


def _bn_batch_error(got, want):
    """Worst over every BatchNorm channel of step 1's batch statistics:
    the mean's difference in units of the channel's standard deviation,
    the variance's relative difference."""
    worst = 0.0
    for k, w in want.items():
        if k.endswith("running_mean"):
            var = want[k[:-4] + "var"] + resnet.BN_EPSILON
            err = (got[k] - w).abs() / var.sqrt()
        else:
            err = (got[k] - w).abs() / (w + resnet.BN_EPSILON)
        worst = max(worst, float(err.max()))
    return worst


def _train_gate(name, pair, single, tmp):
    """The pair's rank reports against one process's: raises on finite
    losses, equal on both ranks, and no kernel launched; returns the
    readings of the three numeric gates and whether all held."""
    losses = [[s["loss"] for s in r["steps"]] for r in pair + single]
    launches = [[s["launches"] for s in r["steps"]] for r in pair + single]
    if (len(losses[0]) != MP_TRAIN_STEPS or losses[0] != losses[1]
            or not np.isfinite(losses).all() or np.any(launches)):
        raise RuntimeError(f"multi-process {name}: losses {losses}, "
                           f"launches {launches}")
    loss_err = [abs(a - b) / abs(b) for a, b in zip(losses[0], losses[2])]

    def load(run, what):
        return torch.load(os.path.join(tmp, f"{run}.rank0.json.{what}.pt"))

    bn_err = _bn_batch_error(load(name, "bn"), load(f"{name}1", "bn"))
    got, want = load(name, "update"), load(f"{name}1", "update")
    update_err = {k: float((got[k] - w).norm() / w.norm().clamp_min(1e-30))
                  for k, w in want.items()}
    groups = {}
    for k, w in want.items():
        g = ("heads" if k.startswith("heads.") else "conv" if w.dim() == 4
             else "bn")
        groups.setdefault(g, []).append(k)
    by_group = {g: float(torch.cat([(got[k] - want[k]).flatten()
                                    for k in ks]).norm()
                         / torch.cat([want[k].flatten() for k in ks]).norm())
                for g, ks in groups.items()}
    worst = max(update_err, key=update_err.get)
    held = (max(loss_err) <= MP_LOSS_RTOL and bn_err <= MP_BN_LIMIT
            and by_group["heads"] <= MP_UPDATE_RTOL)
    return {"losses_two_process": losses[0], "losses_one_process": losses[2],
            "loss_rel_err_by_step": loss_err, "loss_rtol": MP_LOSS_RTOL,
            "bn_step1_batch_stats_worst": bn_err, "bn_limit": MP_BN_LIMIT,
            "update_rel_err_by_group": by_group,
            "update_rtol_heads": MP_UPDATE_RTOL,
            "update_rel_err_median": float(np.median(list(
                update_err.values()))),
            "update_rel_err_worst": update_err[worst],
            "update_rel_err_worst_parameter": worst, "parameters": len(want),
            "gates_held": held}


def _mp_train(label, ranks, tmp, world_yml, name="train"):
    """train_base in one process, then in two on the same world and seed."""
    single = _train_run(ranks, tmp, world_yml, f"{name}1", n=1)
    pair = _train_run(ranks, tmp, world_yml, name)
    gate = _train_gate(name, pair, single, tmp)
    launches = [[s["launches"] for s in r["steps"]] for r in pair]
    line = {
        "what": f"train_base baseM ResNet50 bf16, global batch "
                f"{TRAIN_BATCH} = 2 x {TRAIN_BATCH // 2} (lockstep) against "
                f"one process, {MP_TRAIN_STEPS} steps", **gate,
        "two_process": _train_figures(pair, TRAIN_BATCH),
        "one_process": _train_figures(single, TRAIN_BATCH),
        "peak_mem_GiB_by_rank": [r["peak_mem_GiB"] for r in pair],
        "peak_mem_GiB_one_process": single[0]["peak_mem_GiB"],
        "backend": pair[0]["backend"],
        "grad_allreduce_ms_rank0": pair[0]["allreduce_ms"],
        "kernel_launches_train_steps": [int(x) for x in np.sum(
            launches, axis=(0, 1))], "card": label}
    _mp_print(name, line)
    if name == "train_nccl" and line["backend"] != "nccl":
        raise RuntimeError(f"multi-process {name}: device group "
                           f"{line['backend']}, not nccl, on distinct cards")
    if not gate["gates_held"]:
        raise RuntimeError(f"multi-process {name}: the pair is not one "
                           f"process's: {json.dumps(gate)}")
    return line


def _mp_server(label, ckpt):
    """`serve --shard_batch` over the card's local devices: every answer
    equals `predict_batch` on the batch the server ran (the image padded
    with itself to the batch)."""
    from geoestimation_tpu_torch.serve import server as port_server

    seen = {}
    rng = np.random.default_rng(world.SEED + 8)
    blobs = [_jpeg(_pillow(), rng.integers(0, 256, (300, 280, 3), np.uint8))
             for _ in range(8)]

    def serve_once(self):
        self.start_background()
        try:
            seen["answers"] = [_post(self.port, b) for b in blobs]
            seen["images"] = [self._decode(b)[0][0] for b in blobs]
            seen["engine"] = self.engine
        finally:
            self.close()

    orig = GeoInferenceServer.serve_forever
    GeoInferenceServer.serve_forever = serve_once
    try:
        port_server.main(["--checkpoint", ckpt, "--host", "127.0.0.1",
                          "--port", "0", "--batch_size", str(SERVER_BATCH),
                          "--crops", "10", "--fast", "--shard_batch"])
    finally:
        GeoInferenceServer.serve_forever = orig
    engine = seen["engine"]
    for k, (answer, image) in enumerate(zip(seen["answers"],
                                            seen["images"])):
        ref = engine.predict_batch(np.stack([image] * SERVER_BATCH))
        want = {key: {"class": int(c[0]), "lat": float(la[0]),
                      "lng": float(ln[0])} for key, (c, la, ln) in ref.items()}
        if answer != want:
            raise RuntimeError(f"--shard_batch answer {k} differs from "
                               f"predict_batch: {answer} != {want}")
    _mp_print("server_shard_batch", {
        "requests": len(blobs), "local_devices": engine.layout.n_data,
        "answers_equal_predict_batch": True, "card": label})


def phase_multi(label, tmp, world_yml, config, sd, parts):
    """Multi-process (module docs, 10): returns the launches per forward of
    each rank on the bf16 and int8 eval paths, and each kernel's launches
    in the train steps of both runs."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = _Ranks(tmp)
    try:
        eval_launches = _mp_eval(label, ranks, tmp, config, sd, parts)
        train = _mp_train(label, ranks, tmp, world_yml)
        _mp_server(label, os.path.join(tmp, "mp_ckpt"))
        if torch.cuda.device_count() >= 2:
            _mp_train(label, ranks, tmp, world_yml, name="train_nccl")
        else:
            _mp_print("nccl", "not run: 1 card")
    finally:
        ranks.close()
    log(f"multi-process: phase 10 in {time.perf_counter() - t0:.1f} s")
    return (*eval_launches, train["kernel_launches_train_steps"])


def main():
    t0 = time.perf_counter()
    label, ptxas = phase_device()
    kernels = phase_kernels(label, ptxas)
    config, sd, parts = world.build_world()

    def engine(device="cuda", dtype=torch.bfloat16, **kw):
        return InferenceEngine(config, sd, partitionings=parts, n_crops=10,
                               dtype=dtype, device=device, **kw)

    launches, fast, module, fast_ips = phase_main_path(label, engine)
    host_crops = phase_host_exact(engine, module)
    server_line = phase_server(label, fast)
    del module
    launches["conv_s8"] = phase_int8(label, engine, fast_ips, host_crops)
    tta = phase_tta(label, engine, fast, sd, ptxas, fast_ips)
    del fast
    isn = phase_isn(label)
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, trained, world_yml = phase_train(label, tmp)
        mp, mp8, mp_train = phase_multi(label, tmp, world_yml, config, sd,
                                        parts)
    by_path = {
        "fused_bottleneck": {
            "device_tta": launches["fused_bottleneck"],
            **{f"feature_tta_l{lv}": tta[lv][0] for lv, _ in FTTA_LEVELS},
            "mirror_tta": tta["mirror"][0], "isn": isn["fused_bottleneck"],
            "train_steps": train_launches[0], "trained_checkpoint": trained,
            **{f"two_process_inference_rank{p}": n
               for p, n in enumerate(mp)},
            "two_process_train_steps": mp_train[0]},
        "fused_bottleneck_s2": {"device_tta_use_pallas_s2":
                                launches["fused_bottleneck_s2"],
                                "train_steps": train_launches[1],
                                "two_process_train_steps": mp_train[1]},
        "conv_s8": {"int8": launches["conv_s8"],
                    **{f"int8_feature_tta_l{lv}": tta[f"int8 {lv}"]
                       for lv, _ in FTTA_LEVELS},
                    "int8_isn": isn["conv_s8"],
                    "train_steps": train_launches[2],
                    **{f"two_process_int8_rank{p}": n
                       for p, n in enumerate(mp8)},
                    "two_process_train_steps": mp_train[2]},
    }
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
        entry["launches_by_path"] = by_path[entry["name"]]
    log(f"card: {label}; wall {time.perf_counter() - t0:.1f} s")
    print("server " + json.dumps(server_line))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def planted_faults():
    """`python3 chip_smoke.py --planted-faults`: phase 10's training gates
    against the faults they are there to catch. On phase 9's world, one
    process, then a clean pair and a pair with each of FAULTS planted in
    its ranks; one line of readings each. Fails unless the clean pair holds
    every gate and each faulty pair fails one."""
    require_cuda("chip_smoke")
    label = card_label()
    log(label)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        world_yml = _shard_world(tmp)
        ranks = _Ranks(tmp)
        try:
            single = _train_run(ranks, tmp, world_yml, "train1", n=1)
            held = {}
            for fault in (None, *FAULTS):
                pair = _train_run(ranks, tmp, world_yml, "train",
                                  fault=fault)
                gate = _train_gate("train", pair, single, tmp)
                held[fault] = gate["gates_held"]
                _mp_print("planted_fault", {"fault": fault, **gate,
                                            "card": label})
        finally:
            ranks.close()
    log(f"planted faults in {time.perf_counter() - t0:.1f} s: gates held "
        f"{held}")
    if not held[None] or any(held[f] for f in FAULTS):
        raise RuntimeError(f"the training gates did not tell the faults "
                           f"from the clean pair: held {held}")
    print(json.dumps({"planted_faults": {
        "caught": sorted(FAULTS), "clean_pair_held": True}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        fault, rest = None, sys.argv[3:]
        if rest[:1] == ["--fault"]:
            fault, rest = rest[1], rest[2:]
        rank_main(sys.argv[2], rest[0], rest[1:], fault)
    elif sys.argv[1:] == ["--planted-faults"]:
        planted_faults()
    else:
        main()

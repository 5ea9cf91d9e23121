"""Drives the PyTorch/CUDA port on one GPU and checks it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --planted-faults   # phase 10's training gates
                                             # against planted faults
    python3 chip_smoke.py --phase 10         # phase 10 alone (after the
                                             # kernel build), on every card
    python3 chip_smoke.py --phase 13         # phase 13 alone (after the
                                             # kernel build)
    python3 chip_smoke.py --phase 14         # phase 14 alone (after the
                                             # kernel build)
    python3 chip_smoke.py --phase 15         # phase 15 alone (after the
                                             # kernel build)
    python3 chip_smoke.py --phase 16         # phase 16 alone (after the
                                             # kernel build)

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
     too); launch counts of each run (the fused kernels' and the
     convolution epilogue's, 31 a forward), agreement with the unfolded
     module path, and images/s;
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
     for batches, no inference kernel launched by a train step and the
     train-mode BatchNorm kernels 212 times a step (four for each of the
     53 BatchNorms); `bench_train` at batch 256 with and without remat
     (212 and 316 BatchNorm launches a step), and on one more step: a finite
     loss, every parameter updated as the optimizer computed, and each
     BatchNorm's running
     statistics 0.9 * old + 0.1 * a plain float32 mean and biased variance
     of its input in that step, and the device time by operator of two
     steps (torch.profiler; the BatchNorm kernels by name, and the counter
     `bn_train.launches` of the traced steps, 212 each); an overfit check
     (25 steps on one batch of 64 center crops, the last loss under half
     the first); then the best
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
     process's (relative, in norm), no inference kernel launched by a
     train step
     (`--planted-faults` instead runs a clean pair and pairs with the
     gradient all-reduce, the global BatchNorm sums or their backward's
     sum taken out of their ranks, and fails unless only the clean pair
     holds these gates);
     images/s of both, each rank's peak memory,
     the device group's backend and the gradient all-reduce's ms a step;
     one process's run once more, held against the first the same way
     (how far two runs of one process lie apart in bf16 on cuDNN); the
     model axis: `train_base` in two processes at mesh_shape [1, 2], both
     ranks on the whole batch, the fused head split over them -- by its
     features for the published 23,393 classes (odd), by its classes with
     one more coarse cell (23,394) -- each held to one process at [1, 1]
     by the same gates, its replicated parameters bit for bit alike on
     both ranks, each rank's head bytes half the head's (its
     weight, gradient and momentum; the bias whole where the features
     split), and the checkpoint the pair writes loading into one
     process's classifier and equal, leaf for leaf, to the ranks' last
     states gathered whole (`--planted-faults` also runs both clean
     model-axis pairs and, in each split, pairs with the data axis's sums
     -- BatchNorm statistics, valid counts -- over every rank and with the
     features' gradient not summed or gathered over the model group);
     `serve --shard_batch` over the card's local devices (every answer
     `predict_batch`'s); the training pair on two cards with NCCL where
     there are two, else the line {"multi_process": {"nccl": "not run: 1
     card"}}. One JSON line {"multi_process": {...}} each;
 11. QAT and distillation at full width: `tools.qat_finetune.main` on
     phase 9's best checkpoint and shard world (batch 64 at 224 px, the
     checkpoint's train_crop_scale, 6 steps, lr 1e-4, anchor 0.5, 64
     calibration images, a 32-image parity proxy every 3 steps): every loss
     finite, no kernel launched by a QAT step (each step timed with the card
     synchronized); the export's fake-quant forward within 0.02 of each
     head's logit spread of the int8 network (53 `conv_s8` launches) on
     phase 3's 8 x 10 crops and scales, its argmax that of the int8 trunk
     under float32 heads on at least 99% of the rows; the export served by
     `InferenceEngine(int8=True)` on its `qat` scales (kept from the cache,
     53 launches, logits equal to the plain int8 network's). Then
     `tools.tta_distill.main` on phase 10's checkpoint with its heads fit
     to the three seeded image families of `world.scene_images`
     (`world.fit_heads`), with 16 256-px JPEGs of those families (batch 8,
     10 crops, level 3, adam, lr 1e-5, 4 steps): the start's exact KL at
     most 1e-5, every KL finite, no kernel in a step; the export served
     with feature TTA at level 3 on the kernels on 8 new family images (6
     `fused_bottleneck` launches; logits within the fast-path gates of the
     float32 feature-TTA student on the exported weights, the same folded
     argmax on every image whose float32 margin exceeds 0.2, and at least
     one such image in every head), and in int8 on its `distill` scales
     (53 launches, the plain network's logits).
     Then `tools.quant_study.main` on the QAT export with phase 10's 64
     JPEGs (absmax and p999, 10 crops, batch 32): exit 0, flip rates in
     [0, 1], 53 launches an int8 forward, and at absmax the dynamic int8
     network equal to its plain twin on one batch. One JSON line each
     (ms a step, images/s, peak memory, the teacher pass, the wall);
 12. data preparation to served answers: `geo.create_cells` at the
     paper's three settings (img_min 50, img_max 5000, 2000, 1000) on 4.7M
     seeded MP-16-sized coordinates, with the native S2 library and with
     GEOESTIMATION_NO_NATIVE_S2=1 (the cells and CSVs identical; the
     seconds of each run and the cell counts); `tools.make_demo_world`
     (ResNet50, 512 training records, 64 eval images), the two
     partitioning CLIs on its eval meta CSV (their CSVs those of
     `create_cells` and `assign_classes`), `train_base` on its config for
     4 steps on the card (no inference kernel launched),
     `classification.inference
     --fast --pallas` on the checkpoint (6 `fused_bottleneck` launches a
     forward, a row for every image), and the checkpoint on the fast path
     against the module path as phase 9 serves its own;
 13. the measurement tools, each through its `main` at full width, one
     line each with the card's name and power limit: `tools.bench_ingest`
     (256 seeded JPEGs, 3 iterations, each decode backend that builds);
     `tools.bench_e2e_eval` on 1024 generated JPEGs (one corpus for both
     runs) through the folder pipeline (ResNet50, ten crops, batch 64),
     int8 (53 `conv_s8` launches every forward) then bf16 (no kernel
     launched), its f* answers finite, with the measured window's seconds;
     `tools.bench_stem` at 640 crops (every stem form bit for bit the
     shipped one on the card, on `conv_s8` and on the exact library
     route, at 4 crops and then at 640 on the timed input; one `conv_s8`
     launch a call of s2d, direct and hfold48, none of hfold24 or the
     library); `tools.train_roofline` at batch 256
     (flops and bytes of one step, the BatchNorm kernels' own bytes
     among them, measured against ideal ms, no inference kernel
     launched);
 14. the train-mode BatchNorm kernels (`ops.bn_train`) at every shape of
     ResNet50's 53 BatchNorms in a train step at batch 256 and 224 px, in
     bf16 and float32: each of the four against its plain version on the
     same inputs (the sums, dgamma, dbeta, d1 and d2 within 2e-5 of the
     same steps on the magnitudes; the maps within 2^-7 (float32: 1e-5) of
     the largest value, in bf16 99% of them equal; the residual's gradient
     equal), the two reductions the same bits on a second run; in bf16
     each kernel's device ms (20 calls queued behind a sleeping kernel,
     between CUDA events; maps under the L2's 50 MB read warm) beside its
     bound (the bytes of its maps), the plain version's four steps and
     cuDNN's train-mode BatchNorm forward and backward (the yardstick,
     never called by the port), summed over a step;
 15. the train step's host path: `Trainer`'s `train_fn` on baseM (ResNet50
     bf16, batch 256, seeded weights and two seeded host batches): SGD over
     all leaves (`torch._foreach_*`) bit for bit the per-leaf form, on
     leaves at the model's shapes in float32 and bf16 with and without
     decay and nesterov, and on a copy of the parameters that the per-leaf
     form updates with the gradients of 3 train steps; then 3 warmed-up
     steps under `torch.cuda.set_sync_debug_mode("error")` (nothing in a
     step waits for the card), 212 `bn_train` launches a step, and the ms
     of 10 steps beside the host's ms to queue each;
 16. the fast path's convolution epilogue (`ops.conv_epilogue`): at each
     of its shapes in a ResNet101 forward of 80 and of 640 crops, each form
     on seeded maps with NaN and negative zero planted, bit for bit its
     plain version; its device ms summed over the forward's 82 launches (at
     80 and at 640 crops) beside its bytes bound at the published HBM peak
     (and at the card's measured copy rate) and its plain version's ms;
     the ResNet101 and ResNet50 fast networks and their W-mirrors on 80
     crops, logits bit for bit those with the plain epilogue; its launches
     on each path (82 a ResNet101 forward, 31 a ResNet50 one, none in an
     int8 forward or a train step);
 17. one JSON line describing every kernel (with its launches per forward
     on each path), then the result line {"ok": true, "device": {...}}.

Imports torch, numpy and the standard library only, besides the port
(Pillow too, where it is installed, to make and decode JPEGs; phases 9 to
13 need it, and pandas, which phase 12's CLIs read CSVs with and phase
13's corpus writer imports).
"""

from __future__ import annotations

import contextlib
import io
import json
import multiprocessing
import os
import re
import shutil
import sys
import tempfile
import threading
import time
import types
import unittest.mock
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
from geoestimation_tpu_torch.models import fast_infer
from geoestimation_tpu_torch.models.fast_infer import (
    build_fast_apply,
    build_mirror_tta_apply,
)
from geoestimation_tpu_torch.ops import _build
from geoestimation_tpu_torch.ops import bn_train as ops_bn
from geoestimation_tpu_torch.ops import conv_epilogue as ops_epi
from geoestimation_tpu_torch.ops import conv_s8 as ops8
from geoestimation_tpu_torch.ops import fused_bottleneck as ops
from geoestimation_tpu_torch.parallel import launch
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
from geoestimation_tpu_torch.train.loop import Trainer
from geoestimation_tpu_torch.train.optim import Optimizer, constant_schedule
from geoestimation_tpu_torch.train.step import train_step
from geoestimation_tpu_torch.utils import spans
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
# launches per forward of each configuration at 224 px: (fused_bottleneck,
# _s2, conv_epilogue); the epilogue ends each convolution outside the
# fused kernels, the stem's and three of each other block's
WANT_DEFAULT, WANT_S2 = (6, 0, 31), (6, 1, 28)


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
    """(fn(), (fused_bottleneck, fused_bottleneck_s2, conv_epilogue)
    launches during it), with the counts set to 0 just before."""
    ops.fused_bottleneck.launches = ops.fused_bottleneck_s2.launches = 0
    ops_epi.launches = 0
    out = fn()
    return out, (ops.fused_bottleneck.launches,
                 ops.fused_bottleneck_s2.launches, ops_epi.launches)


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
        f"{launches[1]}, conv_epilogue {launches[2]} (want {want} per "
        f"forward)")
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
    preds, (default_launches, _, default_epi) = _drive("fast", fast, images,
                                                       WANT_DEFAULT)
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
    preds_s2, (_, s2_launches, s2_epi) = _drive("fast_s2", fast_s2, images,
                                                WANT_S2)
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
            "fused_bottleneck_s2": s2_launches,
            "conv_epilogue": default_epi,
            "conv_epilogue_s2": s2_epi}, fast, module, fast_ips


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
    return crops, launches


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
        ops_epi.launches = 0
        if image_mod is not None:
            with multiprocessing.get_context("spawn").Pool(1) as pool:
                answers, latency, wall = pool.apply(
                    _http_burst, (srv.port, blobs, N_CLIENTS))
        else:
            answers, latency, wall = _burst(
                lambda i: srv.batcher.submit(images[i]), N_REQUESTS,
                N_CLIENTS)
        launches = (ops.fused_bottleneck.launches,
                    ops.fused_bottleneck_s2.launches, ops_epi.launches)
        stats = srv.batcher.stats()
        if None in answers or stats["requests"] != N_REQUESTS:
            raise RuntimeError(f"server answered {stats['requests']} of "
                               f"{N_REQUESTS} requests")
        want = tuple(n * stats["batches"] for n in WANT_DEFAULT)
        log(f"server: {stats['batches']} micro-batches, launches "
            f"fused_bottleneck {launches[0]}, fused_bottleneck_s2 "
            f"{launches[1]}, conv_epilogue {launches[2]} (want {want})")
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
            "launches_fused_bottleneck": launches[0],
            "launches_conv_epilogue": launches[2], "card": label}


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
WANT_MIRROR = (12, 0, 62)     # net and netM, each the default path's
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
        f"{launches['mirror'][1]}, conv_epilogue {launches['mirror'][2]} "
        f"(want {WANT_MIRROR})")
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
    preds, (n_fast, _, n_epi) = _drive("isn fast", fast, images,
                                       WANT_DEFAULT)
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
    return {"fused_bottleneck": n_fast, "conv_s8": n_int8,
            "conv_epilogue": n_epi}


# -- phase 9 -------------------------------------------------------------------

TRAIN_STEPS = 12
TRAIN_BATCH = 256
OVERFIT_BATCH = 64
BN_RTOL, BN_ATOL = 1e-3, 1e-5   # fast against two-pass float32 variance
# the train-mode BatchNorm kernels a ResNet50 train step launches: four for
# each of its 53 BatchNorms; with remat the 52 in blocks run their forward's
# two once more
BN_NORMS = len(resnet.train_norms("resnet50", TRAIN_BATCH, 224))
BN_LAUNCHES = 4 * BN_NORMS
BN_LAUNCHES_REMAT = BN_LAUNCHES + 2 * (BN_NORMS - 1)


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
    """(fused_bottleneck, fused_bottleneck_s2, conv_s8, conv_epilogue)
    launches so far."""
    return (ops.fused_bottleneck.launches, ops.fused_bottleneck_s2.launches,
            ops8.conv_s8.launches, ops_epi.launches)


def _as_all(want):
    """A `_counted` count (fused_bottleneck, _s2, conv_epilogue) as
    `_all_launches` orders it, with no conv_s8 launch."""
    return want[0], want[1], 0, want[2]


def _fit(label, path):
    """train_base.main on the world at `path`; returns the trainer, the
    kernels' launches during it and bn_train's a step. The host's wait for
    batches is reported against the wall from the start of main to the
    last step."""
    ops.fused_bottleneck.launches = ops.fused_bottleneck_s2.launches = 0
    ops8.conv_s8.launches = ops_bn.bn_train.launches = ops_epi.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = _Stamped(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        trainer = train_base.main(["--config", path, "--max_steps",
                                   str(TRAIN_STEPS), "--no_resume"])
    wall = time.perf_counter() - t0
    launches = _all_launches()
    bn_launches = ops_bn.bn_train.launches
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
        "bn_train_launches_per_step": bn_launches / TRAIN_STEPS,
        "wall_s": wall, "card": label}
    log("train fit " + json.dumps(line))
    if launches != (0, 0, 0, 0):
        raise RuntimeError(f"train: the train steps launched kernels "
                           f"{launches}")
    if bn_launches != TRAIN_STEPS * BN_LAUNCHES:
        raise RuntimeError(f"train: {bn_launches} bn_train launches in "
                           f"{TRAIN_STEPS} steps, want {BN_LAUNCHES} a step")
    return trainer, launches, bn_launches // TRAIN_STEPS


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

    def recording(x, bn, relu=False, residual=None):
        var, mean = torch.var_mean(x.detach().float(), dim=(0, 2, 3),
                                   unbiased=False)
        seen.append((bn, mean, var))
        return plain(x, bn, relu=relu, residual=residual)

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
    kernel counted once, under the operator that launched it; the
    BatchNorm kernels, launched through ctypes under no operator, by
    kernel), the device's busy share of an unprofiled step of `step_ms`,
    and the counter `bn_train.launches` of the traced steps."""
    kind = torch.autograd.DeviceType
    spans.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step()
        torch.cuda.synchronize()
    launches = spans.summary()["counters"].get("bn_train.launches", 0) / 2
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == kind.CUDA) / 2e3
    by_op = sorted((e for e in events if e.device_type == kind.CPU
                    and e.self_device_time_total > 0),
                   key=lambda e: e.self_device_time_total, reverse=True)
    bn = {}
    for e in events:
        name = re.search(r"bn_\w+_kernel", e.key)
        if e.device_type == kind.CUDA and name:
            bn[name[0]] = bn.get(name[0], 0.0) \
                + e.self_device_time_total / 2e3
    log("train profile " + json.dumps({
        "what": "bench_train step at batch 256, device ms a step by "
                "operator (its kernels' self time, mean of two steps)",
        "device_busy_ms_per_step": busy_ms, "step_ms": step_ms,
        "device_busy_share": busy_ms / step_ms,
        "top": {e.key: e.self_device_time_total / 2e3 for e in by_op[:14]},
        "bn_train_kernels_ms": bn,
        "bn_train_launches_per_traced_step": launches, "card": label}))
    if launches != BN_LAUNCHES:
        raise RuntimeError(f"train: the counter bn_train.launches read "
                           f"{launches} a traced step, want {BN_LAUNCHES}")


def _bench(label):
    """bench_train at batch 256 with and without remat; the checks of
    `_bn_checked_step` on the plain one."""
    out = {}
    for remat in (False, True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, _, _, step = bench_train.setup(TRAIN_BATCH, remat=remat)
        ops_bn.bn_train.launches = 0
        ms, metrics = bench_train.measure(step, 10, torch.device("cuda"))
        per_step = ops_bn.bn_train.launches / 11     # a warm-up step and 10
        out["remat" if remat else "plain"] = {
            "ms_per_step": ms, "images_per_s": TRAIN_BATCH * 1e3 / ms,
            "loss": float(metrics["loss"]),
            "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
            "bn_train_launches_per_step": per_step}
        if per_step != (BN_LAUNCHES_REMAT if remat else BN_LAUNCHES):
            raise RuntimeError(f"train: bench_train (remat {remat}) launched "
                               f"bn_train {per_step} times a step")
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
    preds, (launches, _, _) = _drive("train: trained checkpoint", fast,
                                     images, WANT_DEFAULT)
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
    steps, fused_bottleneck's per forward of the trained checkpoint, the
    world's config path and bn_train's launches a train step."""
    torch.cuda.empty_cache()
    path = _shard_world(tmp)
    trainer, launches, bn_per_step = _fit(label, path)
    ckpt = trainer.tp.checkpoint_dir
    log(f"train: checkpoints {trainer.ckpt.all_steps()}, best "
        f"{trainer.ckpt.best_step()}")
    del trainer
    _bench(label)
    _overfit()
    served = _serve_trained(ckpt, os.path.join(tmp, "val", "*.msgpack"))
    return launches, served, path, bn_per_step


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
    multihost.sum_bn_grads = lambda t: t


def _bn_sums_without_gradient_sum(multihost):
    multihost.sum_bn_grads = lambda t: t


def _sums_over_every_rank(multihost):
    group = multihost.device_group

    def device_sum(t):
        t = t.detach().clone()
        torch.distributed.all_reduce(t, group=group())
        return t

    multihost.sum_over_ranks = multihost.device_sum = device_sum
    multihost.sum_bn_grads = device_sum


def _feature_grad_not_reduced(multihost):
    multihost.model_copy = lambda x: x
    multihost.model_slice = lambda x: multihost._own_slice(
        x, multihost.model_group())


# what `--planted-faults` breaks in a training pair's rank processes: the
# gradient all-reduce; the BatchNorm sums over the ranks, forward and
# backward; the backward's sums alone (`multihost.sum_bn_grads`, which
# `ops.bn_train`'s backward calls), the forward's statistics still global
FAULTS = {"no_grad_allreduce": _no_grad_allreduce,
          "local_bn_statistics": _local_bn_statistics,
          "bn_sums_without_gradient_sum": _bn_sums_without_gradient_sum}
# and in a model-axis pair's: the data axis's sums (BatchNorm statistics
# and the backward's sums, valid counts, metrics) over every rank, where
# model-axis peers hold the same rows (the statistics alone would be exact:
# their element count is summed with them, PERF.md); the features' gradient
# not summed (classes split) or gathered (features split) over the model
# group
MODEL_FAULTS = {"sums_over_every_rank": _sums_over_every_rank,
                "feature_grad_not_reduced": _feature_grad_not_reduced}


def rank_main(report_path, module, argv, fault=None):
    """`python3 chip_smoke.py --rank REPORT [--fault NAME] MODULE ARGS...`:
    a process of phase 10. Runs the port CLI MODULE's main(ARGS) here and
    writes to REPORT what the phase reads: each forward's kernel launches,
    each image's predictions, the int8 calibration's identity, each train
    step's loss, wall, kernel launches and gradient all-reduce ms, the
    device group's backend, the peak memory and the fused head's bytes
    (weight, gradient and momentum of this rank's slice). Rank 0 of a
    training run also saves step 1's batch statistics (recovered from the
    running statistics) to REPORT.bn.pt; every rank saves its parameters'
    update over the run to REPORT.update.pt and its last state (parameters,
    statistics, momentum) to REPORT.final.pt. `--fault` plants one of
    FAULTS or MODEL_FAULTS first."""
    import hashlib
    import importlib

    from geoestimation_tpu_torch.data import image_folder
    from geoestimation_tpu_torch.parallel import multihost
    from geoestimation_tpu_torch.train import loop

    report = {"forwards": [], "images": {}, "steps": [], "backend": None}
    current, saved = {}, {}
    if fault is not None:
        {**FAULTS, **MODEL_FAULTS}[fault](multihost)

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
            if state.step == 0:
                saved["init"] = {k: v.clone()
                                 for k, v in params(state).items()}
                saved["running"] = running(state)
                report["head_bytes"] = 3 * 4 * sum(
                    p.numel() for k, p in state.model.named_parameters()
                    if "fused_head" in k)
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
        state = saved["state"]
        torch.save({k: v - saved["init"][k]
                    for k, v in params(state).items()},
                   report_path + ".update.pt")
        names = [k for k, _ in state.model.named_parameters()]
        torch.save({"model": {k: v.detach().cpu() for k, v in
                              state.model.state_dict().items()},
                    "trace": {k: t.detach().cpu() for k, t in zip(
                        names, state.optimizer.slots["trace"])}},
                   report_path + ".final.pt")
    with open(report_path, "w") as f:
        json.dump(report, f)


def _start_ranks(tmp, name, cli, args, n=2, fault=None):
    """n processes of the port's CLI `cli` in a world of their own
    (`launch.Ranks`: the coordinator flags of their ranks when n > 1, the
    rendezvous store, MP_TIMEOUT_S from the start), each with FAULTS[fault]
    planted if given."""
    reports = [os.path.join(tmp, f"{name}.rank{p}.json") for p in range(n)]
    ranks = launch.Ranks(n, MP_TIMEOUT_S).popen(lambda p: [
        sys.executable, os.path.abspath(__file__), "--rank", reports[p],
        *(["--fault", fault] if fault else []), CLI + cli, *args])
    return name, ranks, reports


def _wait_ranks(started):
    """Each rank's report and output; fails if a rank failed or passed the
    limit (and then kills the group)."""
    name, ranks, reports = started
    try:
        results = ranks.wait()
    except TimeoutError:
        raise RuntimeError(f"multi-process {name}: a rank passed the "
                           f"{MP_TIMEOUT_S} s limit") from None
    for p, (code, out) in enumerate(results):
        if code != 0:
            raise RuntimeError(f"multi-process {name}: rank {p} exited "
                               f"{code}:\n{out[-3000:]}")
    loaded = []
    for path in reports:
        with open(path) as f:
            loaded.append(json.load(f))
    return loaded, [out for _, out in results]


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
    """Every forward of every rank launched the kernels as `want` (an
    `_all_launches` count) says; returns `kernel`'s launches per forward
    per rank."""
    k = {"fused_bottleneck": 0, "fused_bottleneck_s2": 1, "conv_s8": 2,
         "conv_epilogue": 3}[kernel]
    per_rank = []
    for p, r in enumerate(reports):
        fwd = r["forwards"]
        if not fwd or any(tuple(f) != want for f in fwd):
            raise RuntimeError(f"multi-process {name}: rank {p} launches per "
                               f"forward {fwd}, want {want}")
        per_rank.append(fwd[0][k])
    return per_rank


def _mp_eval(label, tmp, config, sd, parts):
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
        _start_ranks(tmp, "test", "test",
                     test + ["--fast", "--json", out["table"]]),
        _start_ranks(tmp, "test1", "test",
                     test + ["--fast", "--json", out["table1"]], n=1),
        _start_ranks(tmp, "inference", "inference", common + [
            "--image_dir", images, "--fast", "--pallas", "--output",
            out["preds"]]),
        _start_ranks(tmp, "inference1", "inference", common + [
            "--image_dir", images, "--fast", "--pallas", "--output",
            out["preds1"]], n=1),
        _start_ranks(tmp, "int8", "test",
                     test + int8 + ["--json", out["int8"]]),
        _start_ranks(tmp, "int8_1", "test", test + int8 + [
            "--calib_dir", images, "--json", out["int8_1"]], n=1),
    ]
    (tst, tst1, inf, inf1, i8, i81) = [_wait_ranks(s)[0] for s in started]
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
                            _as_all(WANT_DEFAULT))
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
    launches8 = _launch_gate("int8", i8, "conv_s8", (0, 0, INT8_LAUNCHES, 0))
    _mp_print("eval", {
        "what": "classification.test --fast (bf16, cuDNN route) in two "
                f"processes on {min(2, torch.cuda.device_count())} card(s) "
                f"against one process, {MP_IMAGES} images x 10 crops, batch "
                f"{MP_BATCH}",
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


def _train_run(tmp, world_yml, name, n=2, fault=None, keep=False):
    """train_base for MP_TRAIN_STEPS steps from the seed in n processes;
    each rank's report. The checkpoints (`tmp/ckpt_<name>`) are removed
    unless `keep`."""
    ckpt = os.path.join(tmp, f"ckpt_{name}")
    shutil.rmtree(ckpt, ignore_errors=True)
    args = ["--config", world_yml, "--max_steps", str(MP_TRAIN_STEPS),
            "--no_resume", "--checkpoint_dir", ckpt]
    reports, _ = _wait_ranks(_start_ranks(tmp, name, "train_base", args,
                                          n=n, fault=fault))
    if not keep:
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


def _load_run(tmp, run, what, rank=0):
    return torch.load(os.path.join(tmp, f"{run}.rank{rank}.json.{what}.pt"))


def _whole(parts, shapes):
    """One tensor per name from each rank's `parts` (a list of dicts), as
    rank 0's checkpoint gathers them: a head slice laid side by side along
    the dim where it is shorter than `shapes[name]`, any other tensor rank
    0's. Also returns the largest difference of a replicated tensor between
    rank 0 and another rank."""
    out, spread = {}, 0.0
    for k, shape in shapes.items():
        ts = [p[k] for p in parts]
        dims = [d for d in range(ts[0].dim()) if ts[0].shape[d] != shape[d]]
        if dims:
            out[k] = torch.cat(ts, dim=dims[0])
            continue
        out[k] = ts[0]
        if ts[0].is_floating_point():
            spread = max([spread] + [float((t - ts[0]).abs().max())
                                     for t in ts[1:]])
    return out, spread


def _compare_runs(tmp, got_run, want_run, n_ranks=1):
    """Rank 0's step-1 batch statistics and the parameters' update over the
    run of `got_run` (its head updates laid whole from `n_ranks` ranks)
    against `want_run`'s (one process): the batch statistics' worst error,
    each parameter's update error (relative, in norm) and each group's."""
    want = _load_run(tmp, want_run, "update")
    got, spread = _whole([_load_run(tmp, got_run, "update", r)
                          for r in range(n_ranks)],
                         {k: v.shape for k, v in want.items()})
    bn_err = _bn_batch_error(_load_run(tmp, got_run, "bn"),
                             _load_run(tmp, want_run, "bn"))
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
    return {"bn_step1_batch_stats_worst": bn_err,
            "replicas_max_abs_diff": spread,
            "update_rel_err_by_group": by_group,
            "update_rel_err_median": float(np.median(list(
                update_err.values()))),
            "update_rel_err_worst": update_err[worst],
            "update_rel_err_worst_parameter": worst, "parameters": len(want)}


def _train_gate(name, pair, single, tmp, single_name=None,
                model_axis=False):
    """The pair's rank reports against one process's (`single_name`,
    default `<name>1`): raises on finite losses, equal on both ranks, and
    no kernel launched; returns the readings of the three numeric gates
    and whether all held. A `model_axis` pair must also hold its
    replicated parameters bit for bit alike on both ranks (the gradient
    all-reduce broadcasts them from the model group's first rank)."""
    losses = [[s["loss"] for s in r["steps"]] for r in pair + single]
    launches = [[s["launches"] for s in r["steps"]] for r in pair + single]
    if (len(losses[0]) != MP_TRAIN_STEPS or losses[0] != losses[1]
            or not np.isfinite(losses).all() or np.any(launches)):
        raise RuntimeError(f"multi-process {name}: losses {losses}, "
                           f"launches {launches}")
    loss_err = [abs(a - b) / abs(b) for a, b in zip(losses[0], losses[2])]
    readings = _compare_runs(tmp, name, single_name or f"{name}1",
                             n_ranks=len(pair))
    held = (max(loss_err) <= MP_LOSS_RTOL
            and readings["bn_step1_batch_stats_worst"] <= MP_BN_LIMIT
            and readings["update_rel_err_by_group"]["heads"]
            <= MP_UPDATE_RTOL
            and not (model_axis and readings["replicas_max_abs_diff"]))
    return {"losses_two_process": losses[0], "losses_one_process": losses[2],
            "loss_rel_err_by_step": loss_err, "loss_rtol": MP_LOSS_RTOL,
            "bn_limit": MP_BN_LIMIT, "update_rtol_heads": MP_UPDATE_RTOL,
            **readings, "gates_held": held}


def _mp_train(label, tmp, world_yml, name="train"):
    """train_base in one process, then in two on the same world and seed."""
    single = _train_run(tmp, world_yml, f"{name}1", n=1)
    pair = _train_run(tmp, world_yml, name)
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
    return line, single


def _mesh_yml(tmp, world_yml, name, mesh_shape, extra_coarse=False):
    """`world_yml` with `mesh_shape`, written as tmp/<name>.yml; with
    `extra_coarse`, the coarse partitioning gains one level-6 cell that no
    record falls in (its class is last, so the labels stay valid): the
    published 3298 + 7202 + 12893 = 23,393 classes, odd, become 23,394,
    even."""
    from geoestimation_tpu_torch.geo import Partitioning, s2
    from geoestimation_tpu_torch.utils.config import save_config

    config = load_config(world_yml)
    config.train_params.mesh_shape = list(mesh_shape)
    if extra_coarse:
        files = list(config.model_params.partitionings.files)
        coarse = Partitioning.from_csv(files[0])
        taken = set(coarse.cell_ids.tolist())
        rng = np.random.default_rng(world.SEED + 12)
        cell = next(int(c) for c in s2.cell_id_at_level(
            rng.uniform(-60, 60, 64), rng.uniform(-180, 180, 64), 6)
            if int(c) not in taken)
        lat, lng = s2.cell_id_to_latlng(np.array([cell], np.uint64))
        files[0] = os.path.join(tmp, f"{name}_coarse.csv")
        Partitioning(
            name=coarse.name,
            tokens=np.append(coarse.tokens, s2.id_to_token(
                np.array([cell], np.uint64))),
            lat=np.append(coarse.lat, lat), lng=np.append(coarse.lng, lng),
            counts=np.append(coarse.counts, 0)).to_csv(files[0])
        config.model_params.partitionings.files = files
    path = os.path.join(tmp, f"{name}.yml")
    save_config(config, path)
    return path


def _ckpt_gate(tmp, name, n_ranks):
    """The pair's checkpoint (kept under tmp/ckpt_<name>) loads into a
    one-process classifier and equals, leaf for leaf and bitwise, the
    ranks' last states laid whole as rank 0 gathers them (the head's and
    its momentum's slices side by side); returns the head's whole shape."""
    from geoestimation_tpu_torch.checkpoint import CheckpointManager
    from geoestimation_tpu_torch.geo import load_partitionings
    from geoestimation_tpu_torch.models.classifier import (
        MultiPartitioningClassifier,
    )

    ckpt = os.path.join(tmp, f"ckpt_{name}")
    config, sd = load_checkpoint(ckpt)
    head = sd["heads.fused_head.weight"].shape
    model = MultiPartitioningClassifier(
        [len(p) for p in load_partitionings(
            config.model_params.partitionings.files)],
        config.model_params.arch)
    model.load_state_dict(sd)
    finals = [_load_run(tmp, name, "final", r) for r in range(n_ranks)]
    got, _ = _whole([f["model"] for f in finals],
                    {k: v.shape for k, v in sd.items()})
    restored = CheckpointManager(ckpt, create=False).restore()
    names = [k for k, _ in model.named_parameters()]
    want_trace = dict(zip(names, restored["optimizer"]["slots"]["trace"]))
    trace, _ = _whole([f["trace"] for f in finals],
                      {k: v.shape for k, v in want_trace.items()})
    bad = [k for k, v in sd.items() if not torch.equal(got[k], v)] + [
        f"momentum {k}" for k, v in want_trace.items()
        if not torch.equal(trace[k], v)]
    if bad or restored["step"] != MP_TRAIN_STEPS:
        raise RuntimeError(f"multi-process {name}: the checkpoint (step "
                           f"{restored['step']}) differs from the ranks' "
                           f"state gathered whole at {bad[:5]}")
    shutil.rmtree(ckpt)
    return tuple(head)


def _mp_model_axis(label, tmp, world_yml, single, name, even):
    """train_base in two processes at mesh_shape [1, 2] (both ranks on the
    whole batch, the fused head split over them: its features for the
    published odd class count, its classes with one more coarse cell)
    against one process at [1, 1] on the same world and seed (`single`, or
    run here for the even count); phase 10's gates, each rank's head bytes
    and peak memory against one process's, and the checkpoint gathered
    whole. Returns the line."""
    yml = _mesh_yml(tmp, world_yml, name, (1, 2), extra_coarse=even)
    single_name = "train1"
    if even:
        single_name = f"{name}1"
        single = _train_run(tmp, _mesh_yml(
            tmp, world_yml, single_name, (1, 1), extra_coarse=True),
            single_name, n=1)
    pair = _train_run(tmp, yml, name, keep=True)
    gate = _train_gate(name, pair, single, tmp, single_name=single_name,
                       model_axis=True)
    head = _ckpt_gate(tmp, name, 2)
    n_total = head[0]
    line = {
        "what": f"train_base baseM ResNet50 bf16 at mesh_shape [1, 2]: the "
                f"fused head {head[0]} x {head[1]} split by "
                f"{'classes' if n_total % 2 == 0 else 'features'} over two "
                f"ranks on the whole batch of {TRAIN_BATCH}, against one "
                f"process, {MP_TRAIN_STEPS} steps", **gate,
        "head_bytes_by_rank": [r["head_bytes"] for r in pair],
        "head_bytes_one_process": single[0]["head_bytes"],
        "peak_mem_GiB_by_rank": [r["peak_mem_GiB"] for r in pair],
        "peak_mem_GiB_one_process": single[0]["peak_mem_GiB"],
        "two_process": _train_figures(pair, TRAIN_BATCH),
        "one_process": _train_figures(single, TRAIN_BATCH),
        "grad_allreduce_ms_rank0": pair[0].get("allreduce_ms"),
        "kernel_launches_train_steps": [int(x) for x in np.sum(
            [[s["launches"] for s in r["steps"]] for r in pair],
            axis=(0, 1))],
        "checkpoint_gathered_whole": True, "card": label}
    _mp_print(name, line)
    # half the weight a rank, and half the bias or (features split) all
    want = 12 * (n_total * head[1] // 2
                 + (n_total if n_total % 2 else n_total // 2))
    if not gate["gates_held"] or any(r["head_bytes"] != want
                                     for r in pair):
        raise RuntimeError(f"multi-process {name}: the model-axis pair is "
                           f"not one process's: {json.dumps(line)}")
    return line


def _mp_drift(label, tmp, world_yml):
    """One process's run of `_mp_train` once more, held against the first
    the way a pair is (PERF.md §6, the pair's drift): how far two runs of
    one process on cuDNN in bf16 lie apart."""
    again = _train_run(tmp, world_yml, "train1b", n=1)
    first = [s["loss"] for s in
             json.load(open(os.path.join(tmp, "train1.rank0.json")))
             ["steps"]]
    losses = [s["loss"] for s in again[0]["steps"]]
    line = {"what": "one process's train_base run twice (6 bf16 steps), "
                    "the second against the first",
            "loss_rel_err_by_step": [abs(a - b) / abs(b)
                                     for a, b in zip(losses, first)],
            **_compare_runs(tmp, "train1b", "train1"), "card": label}
    _mp_print("drift_one_process_twice", line)
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
    try:
        eval_launches = _mp_eval(label, tmp, config, sd, parts)
        train, single = _mp_train(label, tmp, world_yml)
        _mp_drift(label, tmp, world_yml)
        model_axis = [_mp_model_axis(label, tmp, world_yml, single,
                                     name, even)
                      for name, even in (("train_model", False),
                                         ("train_model_even", True))]
        _mp_server(label, os.path.join(tmp, "mp_ckpt"))
        if torch.cuda.device_count() >= 2:
            _mp_train(label, tmp, world_yml, name="train_nccl")
        else:
            _mp_print("nccl", "not run: 1 card")
    finally:
        launch.close_all()
    log(f"multi-process: phase 10 in {time.perf_counter() - t0:.1f} s")
    return (*eval_launches, train["kernel_launches_train_steps"],
            [int(x) for x in np.sum([m["kernel_launches_train_steps"]
                                     for m in model_axis], axis=0)])


# -- phase 11 ------------------------------------------------------------------

QAT_STEPS, QAT_BATCH = 6, 64
DISTILL_IMAGES, DISTILL_BATCH, DISTILL_STEPS = 16, 8, 4
QAT_SPREAD_TOL, QAT_MIN_ARGMAX = 0.02, 0.99  # as tests/test_qat.py:200
DISTILL_START_KL = 1e-5


def _timed_steps(make, record):
    """Wraps the step factory `make` so that each step it makes is timed
    with the card synchronized around it and appends (seconds, the kernels'
    launches during it) to `record`."""
    def wrapped(*args, **kw):
        step = make(*args, **kw)

        def timed(*a, **k):
            torch.cuda.synchronize()
            before, t0 = _all_launches(), time.perf_counter()
            out = step(*a, **k)
            torch.cuda.synchronize()
            record.append((time.perf_counter() - t0,
                           tuple(x - y for x, y in
                                 zip(_all_launches(), before))))
            return out

        return timed

    return wrapped


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _run_tool(main_fn, argv, module=None, factory=None):
    """main_fn(argv) with its output kept, each line timestamped; with
    `factory`, `module.factory`'s steps timed (`_timed_steps`). Returns
    (rc, [(t, line)], [(seconds, launches)] per step, peak GiB, wall s)."""
    steps, out = [], _Stamped(sys.stdout)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stack = contextlib.ExitStack()
    if factory is not None:
        stack.enter_context(_patched(
            module, factory, _timed_steps(getattr(module, factory), steps)))
    t0 = time.perf_counter()
    with stack, contextlib.redirect_stdout(out):
        rc = main_fn(argv)
    torch.cuda.synchronize()
    return (rc, out.lines, steps,
            torch.cuda.max_memory_allocated() / 2 ** 30,
            time.perf_counter() - t0)


def _numbers_after(lines, prefix, key):
    """The float after `key` on each line starting with `prefix`."""
    return [float(line.split(key)[1].split()[0]) for _, line in lines
            if line.startswith(prefix) and key in line]


def _step_figures(name, steps, batch):
    """ms a step past the first and images/s; fails unless every step
    launched no kernel."""
    launches = {l for _, l in steps}
    if launches != {(0, 0, 0, 0)}:
        raise RuntimeError(f"{name}: a train step launched kernels "
                           f"{sorted(launches)}")
    ms = 1e3 * float(np.mean([t for t, _ in steps[1:]]))
    return {"ms_per_step_after_step_1": ms, "images_per_s": batch * 1e3 / ms,
            "steps_timed": len(steps) - 1,
            "kernel_launches_train_steps": [
                int(sum(l[k] for _, l in steps)) for k in range(3)]}


def _qat_vs_int8(sd, arch, scales, n_classes, x_s8):
    """The QAT forward (fake_quant=True) against the int8 network on the
    same crops and scales (53 conv_s8 launches): within QAT_SPREAD_TOL of
    each head's spread; and the argmax on at least QAT_MIN_ARGMAX of the
    rows against the int8 trunk under the float32 heads QAT has (the int8
    network rounds the pooled features to bf16 for its heads, which flips
    near-ties among thousands of classes on random weights); returns the
    readings."""
    from geoestimation_tpu_torch.models import qat

    with torch.no_grad():
        got = qat.build_qat_apply(arch, scales, n_classes=n_classes)(
            qat.fold_variables(sd, arch, device="cuda"), x_s8.float())
    apply8 = quant.build_int8_apply(quant.quantize_model(sd, arch), scales,
                                    n_classes=n_classes, device="cuda")

    def trunk():
        x = apply8.stem_fn(x_s8)
        for block in apply8.block_fns:
            x = block(x)
        return x

    x8, launches = _int8_launches(trunk)
    if launches != INT8_LAUNCHES:
        raise RuntimeError(f"qat: the int8 network launched conv_s8 "
                           f"{launches} times, want {INT8_LAUNCHES}")
    ref = apply8.head_logits(x8)
    last = quant._block_names(resnet.STAGE_SIZES[arch])[-1][0]
    feats = (x8.float().sum(dim=(1, 2)) / (x8.shape[1] * x8.shape[2])
             * float(np.float32(scales[f"{last}_out"])))
    head = (feats @ sd["heads.fused_head.weight"].to("cuda").t()
            + sd["heads.fused_head.bias"].to("cuda"))
    ref32 = torch.split(head, tuple(n_classes), dim=-1)
    out = []
    for g, r, r32 in zip(got, ref, ref32):
        spread = float(r.max() - r.min())
        dev = float((g - r).abs().max())
        agree = float((g.argmax(-1) == r32.argmax(-1)).float().mean())
        out.append({"classes": g.shape[-1], "max_dev_over_spread":
                    dev / spread, "bit_equal_share":
                    float((g == r).float().mean()),
                    "argmax_agreement_float32_heads": agree,
                    "argmax_agreement_bf16_heads":
                    float((g.argmax(-1) == r.argmax(-1)).float().mean()),
                    "max_dev_float32_heads": float((g - r32).abs().max())})
        if dev >= QAT_SPREAD_TOL * spread or agree < QAT_MIN_ARGMAX:
            raise RuntimeError(f"qat: the QAT forward leaves the int8 "
                               f"network's contract: {out[-1]}")
    return out, launches


def _qat(label, tmp, ckpt, images):
    """a. qat_finetune on phase 9's best checkpoint, its export against the
    int8 network and through the int8 engine."""
    from geoestimation_tpu_torch.eval.engine import default_scales_path
    from geoestimation_tpu_torch.models import qat
    from geoestimation_tpu_torch.tools import qat_finetune

    out = os.path.join(tmp, "ckpt_qat")
    rc, lines, steps, peak, wall = _run_tool(qat_finetune.main, [
        "--checkpoint", ckpt, "--out", out, "--steps", str(QAT_STEPS),
        "--lr", "1e-4", "--batch_size", str(QAT_BATCH),
        "--anchor_weight", "0.5", "--calib_images", "64",
        "--eval_images", "32", "--eval_every", "3", "--log_every", "1"],
        qat, "make_qat_train_step")
    losses = _numbers_after(lines, "step ", " loss ")
    kl0 = _numbers_after(lines, "step    -1", "proxy_kl")
    exported = [line for _, line in lines
                if line.startswith("snapshot retention: ")
                and "proxy" in line and "every" not in line]
    if rc != 0 or len(losses) != QAT_STEPS or not np.all(
            np.isfinite(losses)) or len(steps) != QAT_STEPS:
        raise RuntimeError(f"qat: rc {rc}, losses {losses}, steps "
                           f"{len(steps)}")
    figures = _step_figures("qat", steps, QAT_BATCH)
    config, sd = load_checkpoint(out)
    with open(default_scales_path(out)) as f:
        doc = json.load(f)
    engine = InferenceEngine(config, sd, n_crops=10, int8=True,
                             int8_scales_path=default_scales_path(out),
                             search_dirs=[out], device="cuda")
    n_classes = tuple(len(p) for p in engine.partitionings)
    x = torch.as_tensor(images, device="cuda")
    contract, trunk_launches = _qat_vs_int8(
        sd, config.model_params.arch, doc["scales"], n_classes,
        eval_pipeline_s8(x))
    launches = _int8_checks("qat export", engine, None, x,
                            eval_pipeline_s8(x), len(images))
    if engine.int8_calib_source != "cache" or \
            engine.int8_scales != doc["scales"]:
        raise RuntimeError(f"qat: the engine did not keep the qat scales: "
                           f"source {engine.int8_calib_source}")
    line = {"metric": "qat_finetune.main", "steps": QAT_STEPS,
            "batch": QAT_BATCH, "losses": losses, **figures,
            "peak_mem_GiB": peak, "wall_s": wall,
            "proxy_kl_step_minus_1": kl0[0] if kl0 else None,
            "exported": exported[0] if exported else None,
            "scales_source": doc["provenance"]["source"],
            "qat_vs_int8_forward": contract,
            "int8_network_conv_s8_launches": trunk_launches,
            "engine_int8_calib_source": engine.int8_calib_source,
            "engine_conv_s8_launches_per_forward": launches, "card": label}
    log("qat " + json.dumps(line))
    return out, launches, figures["kernel_launches_train_steps"]


def _family_checkpoint(tmp, mp_ckpt, rng):
    """Phase 10's checkpoint with its heads fit to the three seeded image
    families of `world.scene_images` (`world.fit_heads`, on the float32
    module path's features of 12 probe images), so that the families'
    folded margins are decisive; its path."""
    from geoestimation_tpu_torch.checkpoint import save_checkpoint

    config, sd = load_checkpoint(mp_ckpt)
    fp32 = InferenceEngine(config, sd, n_crops=10, dtype=torch.float32,
                           search_dirs=[mp_ckpt], device="cuda")
    probe = torch.as_tensor(world.scene_images(rng, 12), device="cuda")
    with torch.inference_mode():
        feats = fp32.model.backbone(eval_pipeline(probe,
                                                  dtype=torch.float32))
    world.fit_heads(sd, feats, torch.arange(120) // 10 % 3,
                    [len(p) for p in fp32.partitionings])
    out = os.path.join(tmp, "ckpt_families")
    save_checkpoint(out, sd, config)
    return out


def _distill(label, tmp, mp_ckpt):
    """b. tta_distill on phase 10's world with its heads fit to three image
    families, its export served by feature TTA in bf16 on the kernels and
    in int8 on its distill scales, on 8 new images of those families."""
    from geoestimation_tpu_torch.eval.engine import default_scales_path
    from geoestimation_tpu_torch.eval.infer import mean_tta_logits
    from geoestimation_tpu_torch.models import qat, tta_distill as td
    from geoestimation_tpu_torch.tools import tta_distill

    folder = os.path.join(tmp, "distill_images")
    os.makedirs(folder)
    rng, image_mod = np.random.default_rng(world.SEED + 11), _pillow()
    src = _family_checkpoint(tmp, mp_ckpt, rng)
    for i, image in enumerate(world.scene_images(rng, DISTILL_IMAGES)):
        with open(os.path.join(folder, f"d_{i:02d}.jpg"), "wb") as f:
            f.write(_jpeg(image_mod, image))
    images = world.scene_images(rng, 8)
    out = os.path.join(tmp, "ckpt_distill")
    teacher_s = []

    def timed_teacher(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp = teacher(*a, **k)
        torch.cuda.synchronize()
        teacher_s.append(time.perf_counter() - t0)
        return lp

    teacher = td.teacher_log_probs
    with _patched(td, "teacher_log_probs", timed_teacher):
        rc, lines, steps, peak, wall = _run_tool(tta_distill.main, [
            "--checkpoint", src, "--image_dir", folder, "--out", out,
            "--batch_size", str(DISTILL_BATCH), "--images",
            str(DISTILL_IMAGES), "--crops", "10", "--level", "3",
            "--optimizer", "adam", "--lr", "1e-5", "--steps",
            str(DISTILL_STEPS), "--log_every", "2"], td, "make_distill_step")
    start = _numbers_after(lines, "start", "exact-kl")
    kls = (_numbers_after(lines, "", "ftta-kl")
           + _numbers_after(lines, "", "exact-kl"))
    if rc != 0 or len(steps) != DISTILL_STEPS or not start or \
            start[0] > DISTILL_START_KL or not np.all(np.isfinite(kls)):
        raise RuntimeError(f"distill: rc {rc}, start exact-KL {start}, KLs "
                           f"{kls}, steps {len(steps)}")
    figures = _step_figures("distill", steps, DISTILL_BATCH)

    config, sd = load_checkpoint(out)
    arch = config.model_params.arch
    x = torch.as_tensor(images, device="cuda")

    def engine(**kw):
        return InferenceEngine(config, sd, n_crops=10, tta_mode="feature",
                               feature_tta_level=3, search_dirs=[out],
                               device="cuda", **kw)

    bf16 = engine(use_pallas=True)
    n_classes = tuple(len(p) for p in bf16.partitionings)
    preds, counts = _counted(lambda: bf16.predict_batch(images))
    n_fb = counts[0]
    if counts != WANT_DEFAULT:
        raise RuntimeError(f"distill: feature TTA launched {counts}, want "
                           f"{WANT_DEFAULT}")
    with torch.no_grad():
        student = td.build_ftta_apply(arch, n_classes, level=3)(
            qat.fold_variables(sd, arch, device="cuda"), x.float() - 128.0)
    got = bf16.crop_logits(x)
    _hold_logits("distill: feature TTA on the kernels vs the folded "
                 "float32 student", bf16.pred_keys, got, student,
                 10 * len(images))
    folded_agree = {}
    for key, g, r in zip([p.name for p in bf16.partitionings], got,
                         student):
        gf, rf = mean_tta_logits(g, 10), mean_tta_logits(r, 10)
        # predict_batch's classes are its own folded argmax; against the
        # float32 student, every image whose float32 folded margin exceeds
        # the fast-path gate's atol (bf16 rounding decides closer ties)
        if not np.array_equal(
                preds[key][0], gf.argmax(-1).cpu().numpy()):
            raise RuntimeError(f"distill: predict_batch's classes are not "
                               f"its folded argmax on {key}")
        top2 = rf.topk(2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) > FAST_ATOL
        same = gf.argmax(-1) == rf.argmax(-1)
        folded_agree[key] = {
            "same": int(same.sum()), "decisive": int(decisive.sum()),
            "decisive_same": int((same & decisive).sum()),
            "max_margin": float((top2[:, 0] - top2[:, 1]).max()),
            "max_abs_err": float((gf - rf).abs().max())}
        if not same[decisive].all() or not decisive.any():
            raise RuntimeError(f"distill: folded argmax differs on a "
                               f"decisive image of {key}, or no image is "
                               f"decisive: {folded_agree}")
    int8 = engine(int8=True, int8_scales_path=default_scales_path(out))
    launches8 = _int8_checks("distill export feature TTA", int8, None, x,
                             shift_s8(x), len(images),
                             feature_tta={"crop": 224, "n_crops": 10,
                                          "level": 3})
    if int8.int8_calib_source != "cache":
        raise RuntimeError(f"distill: int8 did not keep the distill scales: "
                           f"{int8.int8_calib_source}")
    line = {"metric": "tta_distill.main", "steps": DISTILL_STEPS,
            "batch": DISTILL_BATCH, "images": DISTILL_IMAGES, "crops": 10,
            "level": 3, "start_exact_kl": start[0], "kls": kls,
            "teacher_pass_s": float(sum(teacher_s)), **figures,
            "peak_mem_GiB": peak, "wall_s": wall,
            "feature_tta_fused_bottleneck_per_forward": n_fb,
            "folded_argmax": folded_agree,
            "int8_feature_tta_conv_s8_per_forward": launches8,
            "int8_calib_source": int8.int8_calib_source, "card": label}
    log("distill " + json.dumps(line))
    return n_fb, launches8, figures["kernel_launches_train_steps"]


def _study(label, tmp, qat_ckpt, mp_images, mp_meta):
    """c. quant_study on the QAT export; the dynamic int8 network against
    its plain twin at absmax on one batch."""
    from geoestimation_tpu_torch.data.image_folder import iter_image_folder
    from geoestimation_tpu_torch.tools import quant_study

    json_out = os.path.join(tmp, "study.json")
    ops8.conv_s8.launches = 0
    rc, _, _, peak, wall = _run_tool(quant_study.main, [
        "--checkpoint", qat_ckpt, "--image_dir", mp_images, "--meta",
        mp_meta, "--stats", "absmax,p999", "--crops", "10",
        "--batch_size", "32", "--json", json_out])
    launches = ops8.conv_s8.launches
    with open(json_out) as f:
        results = json.load(f)
    n_batches = -(-results["n_images"] // 32)
    rates = [r for c in results["configs"].values()
             for r in c["flip_rates"].values()]
    if rc != 0 or not rates or not all(0.0 <= r <= 1.0 for r in rates) or \
            launches != INT8_LAUNCHES * 2 * n_batches:
        raise RuntimeError(f"quant_study: rc {rc}, flip rates {rates}, "
                           f"conv_s8 launches {launches} for {n_batches} "
                           f"batches x 2 settings")
    config, sd = load_checkpoint(qat_ckpt)
    arch = config.model_params.arch
    batch = next(iter(iter_image_folder(mp_images, batch_size=8))).images
    samples = quant.calibrate_samples(sd, [batch], arch=arch, device="cuda")
    scales = {k: np.float32(v) for k, v in
              quant.derive_scales(samples, "absmax").items()}
    qnet = quant.quantize_model(sd, arch)
    x = eval_pipeline_s8(torch.as_tensor(batch, device="cuda"))
    dyn, n = _int8_launches(lambda: quant.build_int8_apply_dynamic(
        qnet, device="cuda")(x, scales))
    plain = quant._int8_net(qnet, device="cuda", plain=True)(
        x, quant._upload(quant._prefold(qnet, scales), "cuda"))
    if n != INT8_LAUNCHES or not torch.equal(dyn, plain):
        raise RuntimeError(f"quant_study: the dynamic int8 network launched "
                           f"{n} times or differs from its plain twin")
    line = {"metric": "quant_study.main", "images": results["n_images"],
            "crops": 10, "batch": 32, "settings": sorted(results["configs"]),
            "conv_s8_launches_per_int8_forward":
                launches / (2 * n_batches),
            "flip_rates": {k: c["flip_rates"]
                           for k, c in results["configs"].items()},
            "max_abs_gcd_delta_pt": {k: c["max_abs_gcd_delta_pt"]
                                     for k, c in results["configs"].items()},
            "wall_s": wall, "peak_mem_GiB": peak, "card": label}
    log("quant_study " + json.dumps(line))
    return n


def phase_qat_distill(label, tmp):
    """QAT, distillation and the study (module docs, 11) on phase 9's
    checkpoint and phase 10's world; returns the launches of each path."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rng = np.random.default_rng(world.SEED + 1)     # phase 3's images
    images = rng.integers(0, 256, (8, 256, 256, 3), dtype=np.uint8)
    qat_ckpt, qat_int8, qat_steps = _qat(label, tmp,
                                         os.path.join(tmp, "ckpt"), images)
    ftta, ftta_int8, distill_steps = _distill(
        label, tmp, os.path.join(tmp, "mp_ckpt"))
    study = _study(label, tmp, qat_ckpt, os.path.join(tmp, "mp_images"),
                   os.path.join(tmp, "mp_meta.csv"))
    log(f"qat and distillation: phase 11 in {time.perf_counter() - t0:.1f} s")
    return {"qat_export_int8": qat_int8, "quant_study_int8": study,
            "distilled_feature_tta": ftta,
            "distilled_feature_tta_int8": ftta_int8,
            "qat_train_steps": qat_steps,
            "distill_train_steps": distill_steps}


# -- phase 12 ------------------------------------------------------------------

MP16_POINTS = 4_700_000          # MP-16's photos with coordinates
# img_min, img_max of the paper's three partitionings (SURVEY.md:52-56)
CELL_SETTINGS = ((50, 5000), (50, 2000), (50, 1000))
DEMO_EVAL, DEMO_STEPS = 64, 4


def _mp16_coordinates(rng, n=MP16_POINTS):
    """n seeded photo coordinates: 90% around 3000 centers drawn over the
    sphere with heavy-tailed (Pareto) weights and spread 0.3 degrees, as
    photos crowd into cities; 10% uniform over the sphere."""
    k, background = 3000, n // 10
    clat = np.degrees(np.arcsin(rng.uniform(-0.9, 0.95, k)))
    clng = rng.uniform(-180, 180, k)
    weight = rng.pareto(1.2, k) + 1
    c = rng.choice(k, n - background, p=weight / weight.sum())
    lat = np.concatenate([
        clat[c] + rng.normal(0, 0.3, n - background),
        np.degrees(np.arcsin(rng.uniform(-1, 1, background)))])
    lng = np.concatenate([clng[c] + rng.normal(0, 0.3, n - background),
                          rng.uniform(-180, 180, background)])
    return np.clip(lat, -90, 90), (lng + 180) % 360 - 180


def _cells_at_mp16_scale(label, tmp):
    """create_cells at the paper's three settings on MP16_POINTS seeded
    coordinates, with the native S2 library and on numpy
    (GEOESTIMATION_NO_NATIVE_S2=1): the cells and their CSVs identical;
    the seconds of each run."""
    from geoestimation_tpu_torch.geo import create_cells, native, s2

    lat, lng = _mp16_coordinates(np.random.default_rng(world.SEED + 13))
    if not native.available():
        raise RuntimeError(f"prep: the native S2 library did not build: "
                           f"{native.build_error()}")
    seconds, cells, csvs = {}, {}, {}
    old = os.environ.pop("GEOESTIMATION_NO_NATIVE_S2", None)
    try:
        for backend in ("native", "numpy"):
            if backend == "numpy":
                os.environ["GEOESTIMATION_NO_NATIVE_S2"] = "1"
            if (s2._native() is None) != (backend == "numpy"):
                raise RuntimeError(f"prep: s2 dispatch is not {backend}")
            for img_min, img_max in CELL_SETTINGS:
                t0 = time.perf_counter()
                res = create_cells(lat, lng, img_min=img_min,
                                   img_max=img_max)
                seconds[f"{backend} {img_max}"] = time.perf_counter() - t0
                path = os.path.join(tmp, f"{backend}_{img_max}.csv")
                res.partitioning.to_csv(path)
                with open(path, "rb") as f:
                    csvs[(backend, img_max)] = f.read()
                cells[(backend, img_max)] = (
                    res.partitioning.cell_ids, len(res.partitioning),
                    res.n_images_kept, res.n_rounds)
    finally:
        os.environ.pop("GEOESTIMATION_NO_NATIVE_S2", None)
        if old is not None:
            os.environ["GEOESTIMATION_NO_NATIVE_S2"] = old
    for _, img_max in CELL_SETTINGS:
        a, b = cells[("native", img_max)], cells[("numpy", img_max)]
        if not (np.array_equal(a[0], b[0]) and a[1:] == b[1:]
                and csvs[("native", img_max)] == csvs[("numpy", img_max)]):
            raise RuntimeError(f"prep: create_cells img_max {img_max} "
                               f"differs between native and numpy S2")
    line = {"metric": "create_cells seconds", "points": len(lat),
            "backend_default": "native", "seconds": seconds,
            "cells": {f"50_{m}": cells[("native", m)][1]
                      for _, m in CELL_SETTINGS},
            "images_kept": {f"50_{m}": cells[("native", m)][2]
                            for _, m in CELL_SETTINGS},
            "split_rounds": {f"50_{m}": cells[("native", m)][3]
                             for _, m in CELL_SETTINGS},
            "native_equals_numpy": True, "card": label}
    log("prep cells " + json.dumps(line))


def _forward_launches(fn):
    """fn() with each InferenceEngine forward's kernel launches recorded;
    (fn(), [`_all_launches` count per forward])."""
    per = []
    orig = InferenceEngine._forward

    def counted(self, *a, **k):
        before = _all_launches()
        out = orig(self, *a, **k)
        per.append(tuple(x - y for x, y in zip(_all_launches(), before)))
        return out

    with _patched(InferenceEngine, "_forward", counted):
        return fn(), per


def phase_prep(label, tmp):
    """Data preparation to served answers (module docs, 12); returns
    fused_bottleneck's launches per forward of the inference CLI."""
    import pandas as pd

    from geoestimation_tpu_torch.classification import inference
    from geoestimation_tpu_torch.geo import (
        assign_classes,
        create_cells,
        load_partitionings,
    )
    from geoestimation_tpu_torch.partitioning import assign_classes as ac
    from geoestimation_tpu_torch.partitioning import create_cells as cc
    from geoestimation_tpu_torch.tools import make_demo_world

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _cells_at_mp16_scale(label, tmp)
    root = os.path.join(tmp, "demo")
    make_demo_world.main(["--output", root, "--arch", "resnet50",
                          "--n_eval", str(DEMO_EVAL)])
    meta = os.path.join(root, "eval_meta.csv")
    cells_csv, labels_csv = (os.path.join(root, "cells_1_16.csv"),
                             os.path.join(root, "eval_labels.csv"))
    cc.main(["--dataset", meta, "--output", cells_csv, "--img_min", "1",
             "--img_max", "16"])
    files = [os.path.join(root, "resources", "s2_cells", f"cells_50_{m}.csv")
             for m in (5000, 2000, 1000)] + [cells_csv]
    ac.main(["--dataset", meta, "--output", labels_csv, "--cell_files",
             *files])
    df = pd.read_csv(meta)
    res = create_cells(df.LAT.to_numpy(float), df.LON.to_numpy(float),
                       img_min=1, img_max=16)
    direct = os.path.join(tmp, "cells_direct.csv")
    res.partitioning.to_csv(direct)
    labels = pd.read_csv(labels_csv)
    want = assign_classes(df.LAT.to_numpy(float), df.LON.to_numpy(float),
                          load_partitionings(files))
    with open(cells_csv, "rb") as f, open(direct, "rb") as g:
        same_cells = f.read() == g.read()
    if not same_cells or not np.array_equal(
            labels.iloc[:, 1:].to_numpy().T, want) or (want[-1] < 0).any():
        raise RuntimeError("prep: the partitioning CLIs' CSVs differ from "
                           "create_cells / assign_classes, or an eval image "
                           "lies outside its own cells")
    _zero_launches()
    with contextlib.redirect_stdout(_Stamped(sys.stdout)) as out:
        trainer = train_base.main(["--config",
                                   os.path.join(root, "demo.yml"),
                                   "--max_steps", str(DEMO_STEPS),
                                   "--no_resume"])
    # the demo config logs every 5th step and the last
    logged = {int(line.split()[1].split("/")[0]): float(line.split()[3])
              for _, line in out.lines if line.startswith("step ")}
    losses = list(logged.values())
    ckpt = trainer.tp.checkpoint_dir
    if _all_launches() != (0, 0, 0, 0) or DEMO_STEPS not in logged or \
            not np.all(np.isfinite(losses)):
        raise RuntimeError(f"prep: train_base losses {losses}, launches "
                           f"{_all_launches()}")
    del trainer
    csv = os.path.join(tmp, "demo_preds.csv")
    _, per = _forward_launches(lambda: inference.main([
        "--checkpoint", ckpt, "--image_dir", os.path.join(root,
                                                          "eval_images"),
        "--output", csv, "--fast", "--pallas"]))
    preds = pd.read_csv(csv)
    if not per or set(per) != {_as_all(WANT_DEFAULT)} or \
            preds.iloc[:, 0].nunique() != DEMO_EVAL or \
            not np.isfinite(preds.select_dtypes("number").to_numpy()).all():
        raise RuntimeError(f"prep: inference --fast --pallas launched {per} "
                           f"a forward; {preds.iloc[:, 0].nunique()} images "
                           f"in its CSV")
    served = _serve_trained(ckpt, os.path.join(root, "shards",
                                               "shard_00000.msgpack"))
    line = {"metric": "demo world -> partitioning CLIs -> train_base -> "
                      "inference --fast --pallas",
            "cells_cli_equals_create_cells": True,
            "labels_cli_equals_assign_classes": True,
            "train_losses_logged": logged,
            "inference_fused_bottleneck_per_forward": [f[0] for f in per],
            "served_checkpoint_fused_bottleneck_per_forward": served,
            "rows": len(preds), "wall_s": time.perf_counter() - t0,
            "card": label}
    log("prep " + json.dumps(line))
    return per[0][0]


# -- phase 13 ------------------------------------------------------------------

INGEST_IMAGES, E2E_IMAGES = 256, 1024
STEM_CROPS, STEM_ITERS = 640, 10
ROOFLINE_BATCH, ROOFLINE_ITERS = 256, 10


def _zero_launches():
    ops.fused_bottleneck.launches = ops.fused_bottleneck_s2.launches = 0
    ops8.conv_s8.launches = ops_epi.launches = 0


def _tool_line(tool, line):
    log("tools " + json.dumps({"tool": tool, **line}))


def _e2e_eval(label, precision, corpus):
    """bench_e2e_eval.main on the E2E_IMAGES JPEGs in `corpus` in
    `precision`, each forward of its counted; returns the kernels' launches
    of its forwards, all alike."""
    from geoestimation_tpu_torch.tools import bench_e2e_eval

    per, answers = [], []
    build = bench_e2e_eval.build_forward

    def counted_build(*args, **kw):
        forward = build(*args, **kw)

        def counted(images_u8):
            before = _all_launches()
            out = forward(images_u8)
            per.append(tuple(x - y for x, y in zip(_all_launches(), before)))
            answers.append(out)
            return out

        return counted

    _zero_launches()
    with _patched(bench_e2e_eval, "build_forward", counted_build):
        result = bench_e2e_eval.main(["--image_dir", corpus,
                                      "--n_images", str(E2E_IMAGES),
                                      "--precision", precision])
    want = (0, 0, INT8_LAUNCHES if precision == "int8" else 0, 0)
    finite = all(bool(torch.isfinite(lat).all() and torch.isfinite(lng).all())
                 and cls.shape == (result["batch_size"],)
                 for cls, lat, lng in answers)
    numbers = [result[k] for k in (
        "value", "device_busy_frac", "device_plus_transfer_images_per_sec",
        "device_resident_images_per_sec",
        "host_decode_images_per_sec_per_core", "host_cores_per_chip_budget")]
    if not per or set(per) != {want} or not finite or \
            result["n_images"] != E2E_IMAGES or \
            not all(np.isfinite(v) and v > 0 for v in numbers):
        raise RuntimeError(f"tools: bench_e2e_eval {precision} launched "
                           f"{sorted(set(per))} a forward (want {want}), "
                           f"answers finite {finite}: {result}")
    _tool_line("bench_e2e_eval", {**result, "forwards": len(per),
                                  "window_s": result["n_images"]
                                  / result["value"],
                                  "launches_per_forward": list(per[0]),
                                  "card": label})
    return per[0]


def _stem(label):
    """bench_stem.main at STEM_CROPS crops, each call of a form counted;
    returns conv_s8's launches a call of each form on its kernel route."""
    from geoestimation_tpu_torch.tools import bench_stem

    calls = {}
    build = bench_stem.build_variants

    def counted_build(*args, **kw):
        route = "library" if kw.get("library") else "conv_s8"

        def wrap(name, fn):
            def run(x_s8):
                before = _all_launches()
                out = fn(x_s8)
                calls.setdefault((route, name), set()).add(tuple(
                    x - y for x, y in zip(_all_launches(), before)))
                return out

            run.gemm, run.float32 = fn.gemm, fn.float32
            return run

        return {name: wrap(name, fn) for name, fn in build(*args,
                                                           **kw).items()}

    _zero_launches()
    with _patched(bench_stem, "build_variants", counted_build):
        lines = bench_stem.main(["--crops", str(STEM_CROPS), "--iters",
                                 str(STEM_ITERS)])
    bad = {f"{route} {name}": sorted(seen) for (route, name), seen
           in calls.items()
           if seen != {(0, 0, int(route == "conv_s8"
                                  and name in bench_stem.KERNEL_FORMS), 0)}}
    timed = [l for l in lines if np.isfinite(l["library_ms"])
             and (l["conv_s8_ms"] is None or np.isfinite(l["conv_s8_ms"]))
             and l["bit_identical_at_crops"] == [4, STEM_CROPS]]
    if bad or len(calls) != 2 * len(bench_stem.FORMS) or \
            len(timed) != len(bench_stem.FORMS):
        raise RuntimeError(f"tools: bench_stem launches {bad}, forms called "
                           f"{sorted(calls)}, lines {lines}")
    _tool_line("bench_stem", {"crops": STEM_CROPS, "iters": STEM_ITERS,
                              "bit_identical_on_card_at_crops":
                                  [4, STEM_CROPS],
                              "forms": lines, "card": label})
    return {name: next(iter(calls[("conv_s8", name)]))[2]
            for name in bench_stem.FORMS}


def phase_tools(label):
    """The measurement tools (module docs, 13); returns conv_s8's launches
    a forward of bench_e2e_eval's two paths and a call of each stem form."""
    from geoestimation_tpu_torch.tools import (bench_e2e_eval, bench_ingest,
                                               train_roofline)

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ingest = bench_ingest.main(["--n", str(INGEST_IMAGES), "--iters", "3"])
    if not ingest or ingest[-1]["backend"] != "pil+fast":
        raise RuntimeError(f"tools: bench_ingest ran {ingest}")
    _tool_line("bench_ingest", {"images": INGEST_IMAGES, "iters": 3,
                                "backends": ingest, "card": label})
    with tempfile.TemporaryDirectory(prefix="e2e_corpus_") as corpus:
        t1 = time.perf_counter()
        bench_e2e_eval.generate_corpus(corpus, E2E_IMAGES)
        log(f"tools: generated {E2E_IMAGES} JPEGs in "
            f"{time.perf_counter() - t1:.1f} s")
        e2e = {p: _e2e_eval(label, p, corpus) for p in ("int8", "bf16")}
    stem = _stem(label)
    _zero_launches()
    roof = train_roofline.main(["--batch", str(ROOFLINE_BATCH), "--iters",
                                str(ROOFLINE_ITERS)])
    if _all_launches() != (0, 0, 0, 0) or not roof["flops"] > 0 or \
            not roof["bytes_accessed"] > 0 or \
            not np.isfinite(roof["measured_ms"]):
        raise RuntimeError(f"tools: train_roofline {roof}, launches "
                           f"{_all_launches()}")
    _tool_line("train_roofline", {**roof, "launches": list(_all_launches()),
                                  "card": label})
    log(f"tools: phase 13 in {time.perf_counter() - t0:.1f} s")
    return e2e, stem


# -- phase 14 ------------------------------------------------------------------

BN_CROP = 224
# kernel against plain version on the card: the sums, dgamma, dbeta, d1
# and d2 within 2e-5 of the same steps on the magnitudes (float32 sums of up
# to 3.2M terms in another order); the maps within one unit of the last place
# of bf16 (float32: 1e-5) of the plain version's largest value, and in bf16
# at least 99% of them equal
BN_SUM_TOL = 2e-5
BN_MAP_TOL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-5}
BN_MIN_EQUAL = 0.99


def bn_train_shapes(batch=TRAIN_BATCH, crop=BN_CROP):
    """{((N, C, H, W), form): [names]} of ResNet50's train-mode BatchNorms
    at `batch` images of `crop` px, in the forward's order."""
    out = {}
    for name, shape, form in resnet.train_norms("resnet50", batch, crop):
        out.setdefault((shape, form), []).append(name)
    return out


_FORMS = {"plain": ops_bn.PLAIN, "relu": ops_bn.RELU,
          "residual": ops_bn.ADD_RELU}


def bn_inputs(shape, form, dtype, seed):
    """(x, residual or None, dy, weight, bias): seeded channels-last maps on
    the card, x at mean 0.3 and deviation 1.5, float32 parameters."""
    n, c, h, w = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def nchw(scale=1.0, shift=0.0):
        return (torch.randn((n, h, w, c), generator=gen, device="cuda")
                * scale + shift).to(dtype).permute(0, 3, 1, 2)

    x = nchw(1.5, 0.3)
    res = nchw() if form == "residual" else None
    weight = torch.rand(c, generator=gen, device="cuda") + 0.5
    bias = torch.randn(c, generator=gen, device="cuda") * 0.3
    return x, res, nchw(), weight, bias


def _bn_sum_err(got, ref, magnitude):
    return float(((got - ref).abs() / magnitude.clamp_min(1e-30)).max())


def _bn_map_check(what, got, ref, dtype):
    """(max error over the largest value, share of equal elements); in
    float32 the plain backward's float64 differs in the last places, so
    only bf16's share is held."""
    g, r = got.float(), ref.float()
    err = float((g - r).abs().max())
    scale = max(float(r.abs().max()), 1e-30)
    equal = float((g == r).float().mean())
    if not (torch.isfinite(g).all() and err <= BN_MAP_TOL[dtype] * scale
            and (equal >= BN_MIN_EQUAL or dtype != torch.bfloat16)):
        raise RuntimeError(f"bn_train {what}: max error {err} of "
                           f"{scale}, equal share {equal:.5f}")
    return err / scale, equal


def check_bn_train(shape, form, dtype, seed=0):
    """The four kernels against their plain version at one shape: each on
    the same inputs as its plain version (the kernel's sums feed both);
    two runs of each reduction the same bits. Returns the errors."""
    code, eps = _FORMS[form], resnet.BN_EPSILON
    x, res, dy, weight, bias = bn_inputs(shape, form, dtype, seed)
    sums = ops_bn.stats(x)
    again = ops_bn.stats(x)
    torch.cuda.synchronize()
    ref = ops_bn.stats_reference(x)
    mag = ops_bn.stats_reference(x.abs())
    errs = {"stats": _bn_sum_err(sums, ref, mag)}
    if not torch.equal(sums, again) or errs["stats"] > BN_SUM_TOL:
        raise RuntimeError(f"bn_train stats at {shape} {dtype}: error "
                           f"{errs['stats']}, repeatable "
                           f"{torch.equal(sums, again)}")
    del ref, mag
    out, mean, var = ops_bn.apply(x, sums, weight, bias, eps, code, res)
    torch.cuda.synchronize()
    rout, rmean, rvar = ops_bn.apply_reference(x, sums, weight, bias, eps,
                                               code, res)
    errs["apply"] = _bn_map_check(f"apply at {shape} {form} {dtype}", out,
                                  rout, dtype)
    if not (torch.allclose(mean, rmean, rtol=1e-6, atol=0)
            and torch.allclose(var, rvar, rtol=1e-6, atol=0)):
        raise RuntimeError(f"bn_train apply's statistics at {shape}")
    del rout
    mask = None if code == ops_bn.PLAIN else out
    red = ops_bn.bwd_reduce(dy, mask, x, sums, weight, eps, code)
    red2 = ops_bn.bwd_reduce(dy, mask, x, sums, weight, eps, code)
    torch.cuda.synchronize()
    rred = ops_bn.bwd_reduce_reference(dy, mask, x, sums, weight, eps, code)
    # each row's magnitude: the same steps on the absolute values
    g = dy.float() if mask is None else torch.where(out > 0, dy, 0).float()
    _, _, rstd, _ = ops_bn.channel_stats(sums, eps)
    sg = g.abs().sum(dim=(0, 2, 3))
    sgc = (g * (x.float() - mean[:, None, None])).abs().sum(dim=(0, 2, 3))
    dvar = 0.5 * sgc * weight.abs() * rstd.pow(3)
    rmag = torch.stack([sg, sgc * rstd, ((rstd * weight).abs() * sg
                                         + 2 * mean.abs() * dvar) / sums[-1],
                        dvar / sums[-1]])
    errs["bwd_reduce"] = _bn_sum_err(red, rred, rmag)
    if not torch.equal(red, red2) or errs["bwd_reduce"] > BN_SUM_TOL:
        raise RuntimeError(f"bn_train bwd_reduce at {shape} {form} {dtype}: "
                           f"error {errs['bwd_reduce']}, repeatable "
                           f"{torch.equal(red, red2)}")
    del g, rmag, rred
    dx, dres = ops_bn.bwd_dx(dy, mask, x, sums, weight, red[2:], eps, code)
    torch.cuda.synchronize()
    rdx, rdres = ops_bn.bwd_dx_reference(dy, mask, x, sums, weight, red[2:],
                                         eps, code)
    errs["bwd_dx"] = _bn_map_check(f"bwd_dx at {shape} {form} {dtype}", dx,
                                   rdx, dtype)
    if (dres is None) != (rdres is None) or (
            dres is not None and not torch.equal(dres, rdres)):
        raise RuntimeError(f"bn_train: the residual's gradient at {shape}")
    return errs


def bn_bytes(shape, form, dtype):
    """Bytes each kernel must move at one shape (maps read and written
    once, the per-channel vectors left out)."""
    n, c, h, w = shape
    m = n * c * h * w * torch.finfo(dtype).bits // 8
    res = form == "residual"
    return {"stats": m, "apply": (2 + res) * m,
            "bwd_reduce": (2 + (form != "plain")) * m,
            "bwd_dx": (3 + (form != "plain") + res) * m}


def _queued_ms(fn, reps=20):
    """Device ms of one call of fn(): `reps` calls queued behind a sleeping
    kernel, so that the card runs them back to back whatever the host's
    launch time, between two CUDA events (after a warm-up call). Maps
    under the 50 MB L2 are read warm."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)       # about 25 ms at 1.98 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_bn_train(shape, form, dtype):
    """{kernel: device ms} of the four kernels, of the plain version's four
    steps and of cuDNN's train-mode BatchNorm forward and backward (no
    relu, no residual; the yardstick, which the port never calls) at one
    shape."""
    code, eps = _FORMS[form], resnet.BN_EPSILON
    x, res, dy, weight, bias = bn_inputs(shape, form, dtype, 1)

    def plain():
        s = ops_bn.stats_reference(x)
        o, _, _ = ops_bn.apply_reference(x, s, weight, bias, eps, code, res)
        o = None if code == ops_bn.PLAIN else o
        r = ops_bn.bwd_reduce_reference(dy, o, x, s, weight, eps, code)
        ops_bn.bwd_dx_reference(dy, o, x, s, weight, r[2:], eps, code)

    xg = x.detach().clone().requires_grad_()
    wg, bg = weight.clone().requires_grad_(), bias.clone().requires_grad_()

    def library():
        y = torch.nn.functional.batch_norm(xg, None, None, wg, bg,
                                           training=True, eps=eps)
        torch.autograd.grad(y, (xg, wg, bg), dy)

    sums = ops_bn.stats(x)
    out, _, _ = ops_bn.apply(x, sums, weight, bias, eps, code, res)
    mask = None if code == ops_bn.PLAIN else out
    red = ops_bn.bwd_reduce(dy, mask, x, sums, weight, eps, code)
    ms = {"stats": _queued_ms(lambda: ops_bn.stats(x)),
          "apply": _queued_ms(lambda: ops_bn.apply(x, sums, weight, bias, eps,
                                                   code, res)),
          "bwd_reduce": _queued_ms(lambda: ops_bn.bwd_reduce(
              dy, mask, x, sums, weight, eps, code)),
          "bwd_dx": _queued_ms(lambda: ops_bn.bwd_dx(
              dy, mask, x, sums, weight, red[2:], eps, code)),
          "plain": _queued_ms(plain, reps=3),
          "library": _queued_ms(library)}
    return ms


def phase_bn_train(label):
    """The train-mode BatchNorm kernels (module docs, 14); returns their
    JSON entry (launches filled in from phase 9's train steps)."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    shapes = bn_train_shapes()
    totals = {k: 0.0 for k in ("stats", "apply", "bwd_reduce", "bwd_dx",
                               "bound", "plain", "library")}
    worst = {}
    for (shape, form), names in shapes.items():
        for dtype in (torch.bfloat16, torch.float32):
            errs = check_bn_train(shape, form, dtype)
            for k, v in errs.items():
                v = v if isinstance(v, float) else v[0]
                worst[k] = max(worst.get(k, 0.0), v)
            line = {"kernel": "bn_train", "shape": list(shape), "form": form,
                    "dtype": str(dtype).split(".")[-1], "norms": names,
                    "errors": errs, "card": label}
            if dtype == torch.bfloat16:
                ms = time_bn_train(shape, form, dtype)
                nbytes = bn_bytes(shape, form, dtype)
                bound = {k: bound_ms(0, b)[0] for k, b in nbytes.items()}
                line.update(kernel_ms=ms, bound_ms=bound)
                for k in ("stats", "apply", "bwd_reduce", "bwd_dx"):
                    totals[k] += len(names) * ms[k]
                    totals["bound"] += len(names) * bound[k]
                for k in ("plain", "library"):
                    totals[k] += len(names) * ms[k]
            log("kernel-check " + json.dumps(line))
    kernel_ms = sum(totals[k] for k in ("stats", "apply", "bwd_reduce",
                                        "bwd_dx"))
    entry = {
        "name": "bn_train",
        "route": "cuda",
        "source": "geoestimation_tpu_torch/csrc/bn_train.cu",
        "replaces": None,
        "launches": None,  # filled from phase 9's train steps
        "max_error": worst,
        "ms": kernel_ms,
        "ms_by_kernel": {k: totals[k] for k in ("stats", "apply",
                                                "bwd_reduce", "bwd_dx")},
        "plain_ms": totals["plain"],
        "bound_ms": totals["bound"],
        "bound_by": "bytes",
        "library_ms": totals["library"],
        "what": f"a ResNet50 train step at batch {TRAIN_BATCH} and "
                f"{BN_CROP} px, bf16: every BatchNorm's four kernels, summed",
    }
    log("bn_train " + json.dumps({**entry, "shapes": len(shapes),
                                  "seconds": time.perf_counter() - t0,
                                  "card": label}))
    return entry


# -- phase 15 ------------------------------------------------------------------

HOST_CHECKED_STEPS = 3     # the steps the per-leaf SGD follows bit for bit
HOST_TIMED_STEPS = 10
SGD_CASES = [(0.0, False), (1e-4, False), (1e-4, True)]   # (decay, nesterov)


@torch.no_grad()
def _sgd_per_leaf(opt, lr):
    """SGD leaf by leaf, six launches each: the arrangement the update over
    all leaves at once (`Optimizer.step`) keeps the bits of."""
    for p, t in zip(opt.params, opt.slots["trace"]):
        u = p.grad
        if opt.weight_decay:
            u = u + opt.weight_decay * p
        t.mul_(opt.momentum).add_(u)
        p.sub_(lr * (u + opt.momentum * t if opt.nesterov else t))


def _sgd_on_leaves(shapes):
    """Three updates of leaves at the model's shapes, float32 and bf16, at
    each of SGD_CASES: [(dtype, decay, nesterov)] of those whose leaves or
    traces differ from the per-leaf form's by a bit."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    schedule = lambda count: 0.01 * (count + 1) / 3   # noqa: E731
    off = []
    for dtype in (torch.float32, torch.bfloat16):
        for wd, nesterov in SGD_CASES:
            init = [torch.randn(s, generator=gen, device="cuda").to(dtype)
                    for s in shapes]
            got, want = ([t.clone() for t in init] for _ in range(2))
            kw = dict(momentum=0.9, nesterov=nesterov, weight_decay=wd)
            opt = Optimizer(got, schedule, **kw)
            ref = Optimizer(want, schedule, **kw)
            for k in range(3):
                for p, q in zip(got, want):
                    p.grad = torch.randn(p.shape, generator=gen,
                                         device="cuda").to(dtype)
                    q.grad = p.grad.clone()
                opt.step()
                _sgd_per_leaf(ref, schedule(k))
            if not all(torch.equal(a, b) for a, b in zip(
                    got + opt.slots["trace"], want + ref.slots["trace"])):
                off.append((str(dtype).split(".")[-1], wd, nesterov))
    return off


def _host_path_trainer(tmp):
    """A Trainer of baseM on the card over seeded partitionings at the
    published counts written under `tmp`, its state from the config's seed
    and `train_fn`, and two seeded batches as the loader hands them
    (uint8 256-px images and int64 labels in host memory)."""
    parts = world.seeded_partitionings(np.random.default_rng(world.SEED + 5))
    config = load_config(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "configs", "baseM.yml"))
    files = [os.path.join(tmp, f"{p.name}.csv") for p in parts]
    for p, f in zip(parts, files):
        p.to_csv(f)
    config.model_params.partitionings.files = files
    config.model_params.partitionings.shortnames = [p.name for p in parts]
    config.train_params.checkpoint_dir = os.path.join(tmp, "ckpt")
    trainer = Trainer(config, log_fn=lambda *_: None, device="cuda")
    state = trainer.initial_state(steps_per_epoch=1000)
    rng = np.random.default_rng(world.SEED + 15)
    batches = [types.SimpleNamespace(
        images=rng.integers(0, 256, (TRAIN_BATCH, 256, 256, 3), np.uint8),
        labels=np.stack([rng.integers(0, n, TRAIN_BATCH)
                         for n in world.REAL_CLASS_COUNTS])) for _ in range(2)]
    return trainer, state, trainer._train_fn(), batches


def phase_host_path(label):
    """The train step's host path (module docs, 15)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        trainer, state, train_fn, batches = _host_path_trainer(tmp)
    opt = state.optimizer
    shapes = [tuple(p.shape) for p in opt.params]
    off_leaves = _sgd_on_leaves(shapes)

    # the per-leaf form follows the checked steps on a copy of the
    # parameters, fed the gradients the step computed
    shadow = Optimizer([p.detach().clone() for p in opt.params],
                       opt.schedule, momentum=opt.momentum,
                       nesterov=opt.nesterov, weight_decay=opt.weight_decay)
    update = opt.step

    def update_both():
        for q, p in zip(shadow.params, opt.params):
            q.grad = p.grad.clone()
        _sgd_per_leaf(shadow, opt.schedule(opt.count))
        update()

    opt.step = update_both
    for k in range(HOST_CHECKED_STEPS):
        state, _ = train_fn(state, batches[k % 2])
    del opt.step
    torch.cuda.synchronize()
    off_steps = [n for (n, p), q, t, u in zip(
        state.model.named_parameters(), shadow.params, opt.slots["trace"],
        shadow.slots["trace"]) if not (torch.equal(p, q) and torch.equal(t, u))]
    del shadow

    # warmed up: no call inside a step may wait for the card
    ops_bn.bn_train.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in range(HOST_CHECKED_STEPS):
            state, metrics = train_fn(state, batches[k % 2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    bn_per_step = ops_bn.bn_train.launches / HOST_CHECKED_STEPS
    loss = float(metrics["loss"])

    # the host's time to queue a step against the step's time on the card
    torch.cuda.synchronize()
    host_s = []
    start = time.perf_counter()
    for k in range(HOST_TIMED_STEPS):
        t = time.perf_counter()
        state, metrics = train_fn(state, batches[k % 2])
        host_s.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - start) / HOST_TIMED_STEPS
    line = {
        "what": "Trainer train_fn, ResNet50 baseM bf16 at batch "
                f"{TRAIN_BATCH}, SGD over all leaves, pinned feed",
        "leaves": len(shapes),
        "sgd_cases_off_per_leaf": off_leaves,
        "checked_steps": HOST_CHECKED_STEPS,
        "parameters_off_per_leaf": off_steps[:5],
        "sync_debug_error_steps": HOST_CHECKED_STEPS,
        "bn_train_launches_per_step": bn_per_step, "loss": loss,
        "ms_per_step": step_ms,
        "images_per_s": TRAIN_BATCH * 1e3 / step_ms,
        "host_ms_per_call": [round(1e3 * x, 2) for x in host_s],
        "seconds": time.perf_counter() - t0, "card": label}
    log("train host path " + json.dumps(line))
    del state, trainer, train_fn
    if off_leaves or off_steps or bn_per_step != BN_LAUNCHES or \
            not np.isfinite(loss):
        raise RuntimeError(f"train host path: SGD cases off the per-leaf "
                           f"form {off_leaves}, parameters off it after "
                           f"{HOST_CHECKED_STEPS} steps {off_steps[:5]}, "
                           f"{bn_per_step} bn_train launches a step (want "
                           f"{BN_LAUNCHES}), loss {loss}")
    return line


# -- phase 16 ------------------------------------------------------------------

EPI_N = 80
EPI_CELL_N = 640          # the crops of a benchmark call: 64 photos x 10
EPI_FORMS = ("bias_relu", "bias_add_relu", "bias_add_relu_ds")
# launches a forward with use_pallas at 224 px: the stem, then three a block
# of every block the fused kernel does not take
EPI_LAUNCHES = {"resnet101": 82, "resnet50": 31}


def epilogue_shapes(arch="resnet101", n=EPI_N, crop=224):
    """{((N, C, H, W), form): launches} of the fast path's convolution
    epilogues in one forward of `n` crops with `use_pallas`: the stem, and
    conv1, conv2 and conv3 of each block outside the fused kernel (layer1's
    and layer2's stride-1 blocks), in the forward's order."""
    out = {}

    def add(c, h, form):
        out[(n, c, h, h), form] = out.get(((n, c, h, h), form), 0) + 1

    h = crop // 2
    add(64, h, "bias_relu")
    h //= 2                                   # the max pool
    for stage, blocks in enumerate(resnet.STAGE_SIZES[arch]):
        cmid = 64 * 2 ** stage
        for b in range(blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            if stride == 1 and stage in fast_infer.PALLAS_STAGES:
                continue
            add(cmid, h, "bias_relu")
            h //= stride
            add(cmid, h, "bias_relu")
            add(4 * cmid, h, "bias_add_relu_ds" if b == 0 else
                "bias_add_relu")
    return out


def epilogue_inputs(shape, form, seed, plant=True):
    """(y, b, res, bres) of one epilogue on the card: seeded channels-last
    bf16 maps and (C, 1, 1) bf16 biases, res None for bias_relu and bres
    for all but bias_add_relu_ds. With `plant`, NaN in every 997th element
    of y and res, and negative zero in channel 0 of every 7th row of y and
    res and in channel 0 of b and bres (so that sums of negative zeros
    reach relu)."""
    n, c, h, w = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def nchw():
        return torch.randn((n, h, w, c), generator=gen, device="cuda").to(
            torch.bfloat16).permute(0, 3, 1, 2)

    def vec():
        return (torch.randn(c, generator=gen, device="cuda") * 0.5).to(
            torch.bfloat16)[:, None, None]

    y, b = nchw(), vec()
    res = None if form == "bias_relu" else nchw()
    bres = vec() if form == "bias_add_relu_ds" else None
    if plant:
        for t in (y, res):
            if t is not None:
                rows = t.permute(0, 2, 3, 1).view(-1, c)
                rows.view(-1)[::997] = float("nan")
                rows[::7, 0] = -0.0
        for t in (b, bres):
            if t is not None:
                t[0] = -0.0
    return y, b, res, bres


def epilogue_op(form, y, b, res, bres, plain=False):
    """`form`'s entry point of `ops.conv_epilogue` on y in place, or its
    plain version."""
    if form == "bias_relu":
        fn = ops_epi.bias_relu_reference if plain else ops_epi.bias_relu_
        return fn(y, b)
    fn = ops_epi.bias_add_relu_reference if plain else ops_epi.bias_add_relu_
    return fn(y, b, res, bres)


def _bits(t):
    return t.view(torch.int16)


def check_epilogue(shape, form, seed=0):
    """The kernel on `epilogue_inputs` against its plain version: one
    launch, in place, every output bit equal (int16 views, so that NaN and
    negative zero count). Returns the NaNs and negative zeros of the
    output."""
    y, b, res, bres = epilogue_inputs(shape, form, seed)
    plain = epilogue_op(form, y.clone(), b, res, bres, plain=True)
    before = ops_epi.launches
    got = epilogue_op(form, y, b, res, bres)
    torch.cuda.synchronize()
    same = torch.equal(_bits(got), _bits(plain))
    if ops_epi.launches != before + 1 or got.data_ptr() != y.data_ptr() \
            or not same:
        raise RuntimeError(
            f"conv_epilogue {form} at {shape}: launches "
            f"{ops_epi.launches - before}, in place "
            f"{got.data_ptr() == y.data_ptr()}, bits equal to the plain "
            f"version {same}")
    return {"nan": int(torch.isnan(got).sum()),
            "negative_zero": int(((got == 0) & torch.signbit(got)).sum())}


def epilogue_bytes(shape, form):
    """Bytes the kernel must move at one shape: y read and written, the
    residual read, the biases read."""
    n, c, h, w = shape
    maps = 2 if form == "bias_relu" else 3
    return 2 * (maps * n * c * h * w + c * (1 + (form == "bias_add_relu_ds")))


def card_bandwidth():
    """Bytes a second of a 1 GiB device-to-device copy (read and written):
    a second bytes bound is taken at this rate, beside the published
    peak's."""
    src = torch.zeros(2 ** 29, dtype=torch.bfloat16, device="cuda")
    dst = torch.empty_like(src)
    ms = _queued_ms(lambda: dst.copy_(src), reps=10)
    del src, dst
    return 2 * 2 ** 30 / (ms * 1e-3)


def time_epilogue(shapes, bandwidth):
    """{kernel, plain, bound, bound_copy}: device ms summed over a forward's
    launches at `shapes`; the kernel and its plain version, each on fresh
    unplanted inputs in place, 20 calls queued; the bytes bound at the
    published peak and at the measured copy rate `bandwidth`."""
    total = {"kernel": 0.0, "plain": 0.0, "bound": 0.0, "bound_copy": 0.0}
    for (shape, form), count in shapes.items():
        for name, plain in (("kernel", False), ("plain", True)):
            y, b, res, bres = epilogue_inputs(shape, form, 1, plant=False)
            total[name] += count * _queued_ms(
                lambda: epilogue_op(form, y, b, res, bres, plain=plain))
            del y, b, res, bres
        nbytes = epilogue_bytes(shape, form)
        total["bound"] += count * bound_ms(0, nbytes)[0]
        total["bound_copy"] += count * 1e3 * nbytes / bandwidth
    return total


def _epilogue_network_bits(sd, arch, mirror, n=EPI_N):
    """(launches a forward, bit-equal) of the `arch` fast network with
    `use_pallas` (its W-mirror with `mirror`) on n seeded normalized crops:
    its logits against the same network's with the plain epilogue."""
    apply = build_fast_apply(sd, arch, use_pallas=True, mirror=mirror)
    x = torch.randn((n, 224, 224, 3), generator=torch.Generator(
        device="cuda").manual_seed(16), device="cuda")
    with torch.inference_mode():
        before = ops_epi.launches
        got = apply(x)
        torch.cuda.synchronize()
        launches = ops_epi.launches - before
        with unittest.mock.patch.multiple(
                fast_infer, bias_relu_=ops_epi.bias_relu_reference,
                bias_add_relu_=ops_epi.bias_add_relu_reference):
            plain = apply(x)
    torch.cuda.synchronize()
    return launches, torch.equal(_bits(got), _bits(plain))


def _epilogue_other_paths():
    """conv_epilogue launches across an int8 ResNet50 forward of 80 crops
    and across a ResNet50 train step at batch 32."""
    config, sd, parts = world.build_world(counts=(40, 120, 360))
    images = np.random.default_rng(16).integers(0, 256, (8, 256, 256, 3),
                                                dtype=np.uint8)
    eng = InferenceEngine(config, sd, partitionings=parts, n_crops=10,
                          device="cuda", int8=True)
    eng.predict_batch(images)       # calibrates on its first batch
    torch.cuda.synchronize()
    before = ops_epi.launches
    eng.predict_batch(images)
    torch.cuda.synchronize()
    out = {"int8_forward": ops_epi.launches - before}
    del eng
    _, _, _, step = bench_train.setup(32, n_classes=(40, 120, 360))
    step()
    torch.cuda.synchronize()
    before = ops_epi.launches
    step()
    torch.cuda.synchronize()
    out["train_step"] = ops_epi.launches - before
    return out


def phase_conv_epilogue(label):
    """The fast path's convolution epilogue (module docs, 16); returns its
    JSON entry."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    shapes = epilogue_shapes()
    planted = {}
    for (shape, form), count in shapes.items():
        planted[form] = check_epilogue(shape, form)
        log("kernel-check " + json.dumps({
            "kernel": "conv_epilogue", "shape": list(shape), "form": form,
            "launches_a_forward": count, "bits_equal": True,
            "output": planted[form], "card": label}))
    for shape, form in epilogue_shapes(n=EPI_CELL_N):    # the cell's batch
        check_epilogue(shape, form, seed=1)
    for form in EPI_FORMS:      # an odd batch, a ragged last stretch of rows
        check_epilogue((3, 256, 13, 11), form, seed=2)
    bandwidth = card_bandwidth()
    ms = time_epilogue(shapes, bandwidth)
    ms_cell = time_epilogue(epilogue_shapes(n=EPI_CELL_N), bandwidth)
    torch.cuda.empty_cache()
    by_path, bits = {}, {}
    for arch in ("resnet101", "resnet50"):
        _, sd, _ = world.build_world(arch=arch, counts=(40, 120, 360))
        for mirror in (False, True):
            name = f"{arch}_fast{'_mirror' if mirror else ''}_forward"
            by_path[name], bits[name] = _epilogue_network_bits(sd, arch,
                                                               mirror)
        del sd
    by_path.update(_epilogue_other_paths())
    want = {"resnet101_fast_forward": EPI_LAUNCHES["resnet101"],
            "resnet101_fast_mirror_forward": EPI_LAUNCHES["resnet101"],
            "resnet50_fast_forward": EPI_LAUNCHES["resnet50"],
            "resnet50_fast_mirror_forward": EPI_LAUNCHES["resnet50"],
            "int8_forward": 0, "train_step": 0}
    if sum(shapes.values()) != EPI_LAUNCHES["resnet101"] or \
            by_path != want or not all(bits.values()):
        raise RuntimeError(f"conv_epilogue: launches by path {by_path} "
                           f"(want {want}), network logits bit for bit the "
                           f"plain epilogue's {bits}")
    entry = {
        "name": "conv_epilogue",
        "route": "cuda",
        "source": "geoestimation_tpu_torch/csrc/conv_epilogue.cu",
        "replaces": None,
        "launches": by_path["resnet101_fast_forward"],
        "launches_by_path": by_path,
        "network_bits_equal": bits,
        "output_planted": planted,
        "ms": ms["kernel"],
        "plain_ms": ms["plain"],
        "bound_ms": ms["bound"],
        "bound_ms_copy": ms["bound_copy"],
        "bound_by": "bytes",
        "library_ms": None,
        "bandwidth_gbps": bandwidth * 1e-9,
        "n640": ms_cell,
        "what": f"a ResNet101 fast forward of {EPI_N} crops at 224 px: the "
                f"{EPI_LAUNCHES['resnet101']} convolution epilogues, summed",
    }
    log("conv_epilogue " + json.dumps({**entry, "shapes": len(shapes),
                                       "seconds": time.perf_counter() - t0,
                                       "card": label}))
    return entry


def main():
    t0 = time.perf_counter()
    label, ptxas = phase_device()
    kernels = phase_kernels(label, ptxas)
    config, sd, parts = world.build_world()

    def engine(device="cuda", dtype=torch.bfloat16, **kw):
        return InferenceEngine(config, sd, partitionings=parts, n_crops=10,
                               dtype=dtype, device=device, **kw)

    launches, fast, module, fast_ips = phase_main_path(label, engine)
    host_crops, host_exact = phase_host_exact(engine, module)
    server_line = phase_server(label, fast)
    del module
    launches["conv_s8"] = phase_int8(label, engine, fast_ips, host_crops)
    tta = phase_tta(label, engine, fast, sd, ptxas, fast_ips)
    del fast
    isn = phase_isn(label)
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, trained, world_yml, bn_per_step = phase_train(label,
                                                                      tmp)
        mp, mp8, mp_train, mp_model = phase_multi(label, tmp, world_yml,
                                                  config, sd, parts)
        qd = phase_qat_distill(label, tmp)
        demo = phase_prep(label, tmp)
    e2e, stem = phase_tools(label)
    kernels.append(phase_bn_train(label))
    phase_host_path(label)
    kernels.append(phase_conv_epilogue(label))
    by_path = {
        "fused_bottleneck": {
            "device_tta": launches["fused_bottleneck"],
            **{f"feature_tta_l{lv}": tta[lv][0] for lv, _ in FTTA_LEVELS},
            "mirror_tta": tta["mirror"][0], "isn": isn["fused_bottleneck"],
            "train_steps": train_launches[0], "trained_checkpoint": trained,
            **{f"two_process_inference_rank{p}": n
               for p, n in enumerate(mp)},
            "two_process_train_steps": mp_train[0],
            "qat_train_steps": qd["qat_train_steps"][0],
            "distill_train_steps": qd["distill_train_steps"][0],
            "distilled_feature_tta": qd["distilled_feature_tta"],
            "model_axis_train_steps": mp_model[0],
            "demo_world_inference_cli": demo,
            "bench_e2e_eval_int8": e2e["int8"][0],
            "bench_e2e_eval_bf16": e2e["bf16"][0]},
        "fused_bottleneck_s2": {"device_tta_use_pallas_s2":
                                launches["fused_bottleneck_s2"],
                                "train_steps": train_launches[1],
                                "two_process_train_steps": mp_train[1],
                                "qat_train_steps":
                                    qd["qat_train_steps"][1],
                                "distill_train_steps":
                                    qd["distill_train_steps"][1],
                                "model_axis_train_steps": mp_model[1],
                                "bench_e2e_eval_int8": e2e["int8"][1],
                                "bench_e2e_eval_bf16": e2e["bf16"][1]},
        "conv_s8": {"int8": launches["conv_s8"],
                    **{f"int8_feature_tta_l{lv}": tta[f"int8 {lv}"]
                       for lv, _ in FTTA_LEVELS},
                    "int8_isn": isn["conv_s8"],
                    "train_steps": train_launches[2],
                    **{f"two_process_int8_rank{p}": n
                       for p, n in enumerate(mp8)},
                    "two_process_train_steps": mp_train[2],
                    "qat_train_steps": qd["qat_train_steps"][2],
                    "distill_train_steps": qd["distill_train_steps"][2],
                    "qat_export_int8": qd["qat_export_int8"],
                    "quant_study_int8": qd["quant_study_int8"],
                    "distilled_feature_tta_int8":
                        qd["distilled_feature_tta_int8"],
                    "model_axis_train_steps": mp_model[2],
                    "bench_e2e_eval_int8": e2e["int8"][2],
                    "bench_e2e_eval_bf16": e2e["bf16"][2],
                    **{f"bench_stem_{form}": n for form, n in stem.items()}},
        "bn_train": {"train_steps": bn_per_step,
                     "bench_train_step": BN_LAUNCHES,
                     "bench_train_remat_step": BN_LAUNCHES_REMAT},
        "conv_epilogue": {
            "device_tta": launches["conv_epilogue"],
            "device_tta_use_pallas_s2": launches["conv_epilogue_s2"],
            "host_exact": host_exact[2],
            "server_per_batch": server_line["launches_conv_epilogue"]
            / server_line["batches"],
            **{f"feature_tta_l{lv}": tta[lv][2] for lv, _ in FTTA_LEVELS},
            "mirror_tta": tta["mirror"][2], "isn": isn["conv_epilogue"],
            **kernels[-1]["launches_by_path"]},
    }
    launches["bn_train"] = bn_per_step
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
    process, then a clean data-axis pair and a pair with each of FAULTS
    planted in its ranks, then clean model-axis pairs (mesh_shape [1, 2]:
    the published head split by its features, and with one more coarse
    cell by its classes, against a one-process run of its own) and one
    with each of MODEL_FAULTS; one line of readings each. Fails unless
    each clean pair holds every gate and each faulty pair fails one."""
    require_cuda("chip_smoke")
    label = card_label()
    log(label)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        world_yml = _shard_world(tmp)
        try:
            held = {}
            for yml, name, single_yml, faults in (
                    (world_yml, "train", world_yml, FAULTS),
                    (_mesh_yml(tmp, world_yml, "world_model", (1, 2)),
                     "train_model", world_yml, MODEL_FAULTS),
                    (_mesh_yml(tmp, world_yml, "world_classes", (1, 2),
                               extra_coarse=True), "train_classes",
                     _mesh_yml(tmp, world_yml, "world_classes1", (1, 1),
                               extra_coarse=True), MODEL_FAULTS)):
                single = _train_run(tmp, single_yml, f"{name}1", n=1)
                for fault in (None, *faults):
                    pair = _train_run(tmp, yml, name, fault=fault)
                    gate = _train_gate(name, pair, single, tmp,
                                       model_axis=faults is MODEL_FAULTS)
                    held[(name, fault)] = gate["gates_held"]
                    _mp_print("planted_fault", {"pair": name,
                                                "fault": fault, **gate,
                                                "card": label})
        finally:
            launch.close_all()
    log(f"planted faults in {time.perf_counter() - t0:.1f} s: gates held "
        f"{held}")
    clean = [v for (_, f), v in held.items() if f is None]
    if len(clean) != 3 or not all(clean) or any(
            v for (_, f), v in held.items() if f is not None):
        raise RuntimeError(f"the training gates did not tell the faults "
                           f"from the clean pairs: held {held}")
    print(json.dumps({"planted_faults": {
        "caught": sorted(FAULTS) + sorted(MODEL_FAULTS),
        "pairs": sorted({n for n, _ in held}),
        "clean_pairs_held": True}}), flush=True)


def phase_10_alone():
    """`python3 chip_smoke.py --phase 10`: phase 1's build, then phase 10
    on phase 3's world and phase 9's shard world, on every card there is
    (with two or more, each rank on a card of its own and the device group
    NCCL); one line of its wall and backend after phase 10's own lines."""
    label, _ = phase_device()
    t0 = time.perf_counter()
    config, sd, parts = world.build_world()
    with tempfile.TemporaryDirectory() as tmp:
        world_yml = _shard_world(tmp)
        phase_multi(label, tmp, world_yml, config, sd, parts)
    print(json.dumps({"phase_10": {
        "ok": True, "cards": torch.cuda.device_count(),
        "wall_s": time.perf_counter() - t0, "card": label}}), flush=True)


def phase_13_alone():
    """`python3 chip_smoke.py --phase 13`: phase 1's build, then phase 13;
    one line of its launches and wall after phase 13's own lines."""
    label, _ = phase_device()
    t0 = time.perf_counter()
    e2e, stem = phase_tools(label)
    print(json.dumps({"phase_13": {
        "ok": True, "conv_s8_bench_e2e_eval_int8": e2e["int8"][2],
        "conv_s8_bench_e2e_eval_bf16": e2e["bf16"][2],
        **{f"conv_s8_bench_stem_{form}": n for form, n in stem.items()},
        "wall_s": time.perf_counter() - t0, "card": label}}), flush=True)


def phase_15_alone():
    """`python3 chip_smoke.py --phase 15`: phase 1's build, then phase 15;
    one line of its wall after phase 15's own lines."""
    label, _ = phase_device()
    t0 = time.perf_counter()
    line = phase_host_path(label)
    print(json.dumps({"phase_15": {
        "ok": True, "ms_per_step": line["ms_per_step"],
        "wall_s": time.perf_counter() - t0, "card": label}}), flush=True)


def phase_14_alone():
    """`python3 chip_smoke.py --phase 14`: phase 1's build, then phase 14;
    one line of its wall after phase 14's own lines."""
    label, _ = phase_device()
    t0 = time.perf_counter()
    entry = phase_bn_train(label)
    print(json.dumps({"phase_14": {
        "ok": True, "ms": entry["ms"], "bound_ms": entry["bound_ms"],
        "wall_s": time.perf_counter() - t0, "card": label}}), flush=True)


def phase_16_alone():
    """`python3 chip_smoke.py --phase 16`: phase 1's build, then phase 16;
    one line of its wall after phase 16's own lines."""
    label, _ = phase_device()
    t0 = time.perf_counter()
    entry = phase_conv_epilogue(label)
    print(json.dumps({"phase_16": {
        "ok": True, "ms": entry["ms"], "bound_ms": entry["bound_ms"],
        "plain_ms": entry["plain_ms"], "wall_s": time.perf_counter() - t0,
        "card": label}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        fault, rest = None, sys.argv[3:]
        if rest[:1] == ["--fault"]:
            fault, rest = rest[1], rest[2:]
        rank_main(sys.argv[2], rest[0], rest[1:], fault)
    elif sys.argv[1:] == ["--planted-faults"]:
        planted_faults()
    elif sys.argv[1:] == ["--phase", "10"]:
        phase_10_alone()
    elif sys.argv[1:] == ["--phase", "13"]:
        phase_13_alone()
    elif sys.argv[1:] == ["--phase", "14"]:
        phase_14_alone()
    elif sys.argv[1:] == ["--phase", "15"]:
        phase_15_alone()
    elif sys.argv[1:] == ["--phase", "16"]:
        phase_16_alone()
    else:
        main()

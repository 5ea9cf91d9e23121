"""Drives the PyTorch/CUDA port on one GPU and checks it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions, and the build of every CUDA kernel from csrc/ (timed);
  2. every kernel against its plain PyTorch version on the card, in bf16, at
     the shapes the main path gives it and at a ragged shape, with times;
  3. the main path: ten-crop bf16 ResNet50 inference at full width (three
     heads at 3298/7202/12893 classes, random weights from a seed) through
     `InferenceEngine.predict_batch` with the BN-folded fast path and the
     hand-written kernels; launch counts, agreement with the unfolded module
     path, and images/s;
  4. one JSON line describing every kernel, then the result line
     {"ok": true, "device": {...}}.

Imports torch, numpy and the standard library only, besides the port.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12    # HBM3 rate, H100 SXM
SEED = 0

# (label, N, H, W, Cin, Cmid, Cout, projection, launches per forward):
# the stride-1 blocks of layer1 and layer2 of ResNet50 at 224 px, N = 8
# images x 10 crops.
MAIN_SHAPES = [
    ("layer1.0 56x56 64-64-256 proj", 80, 56, 56, 64, 64, 256, True, 1),
    ("layer1.1-2 56x56 256-64-256", 80, 56, 56, 256, 64, 256, False, 2),
    ("layer2.1-3 28x28 512-128-512", 80, 28, 28, 512, 128, 512, False, 3),
]
RAGGED_SHAPE = ("ragged 13x11 64-64-256 proj", 3, 13, 11, 64, 64, 256, True, 0)
KERNEL_RTOL = KERNEL_ATOL = 0.05     # as tests/test_fused_block.py
KERNEL_MIN_BITWISE = 0.9


def log(msg):
    print(msg, flush=True)


def card_label():
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


# -- phase 1 -------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA GPU")
    from geoestimation_tpu_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return label


# -- phase 2 -------------------------------------------------------------------

def _block_inputs(n, h, w, cin, cmid, cout, proj, gen):
    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        t = torch.randn(shape, generator=gen, device="cuda") * scale
        return t.to(dtype).contiguous()

    x = rnd(n, h, w, cin)
    args = [x, rnd(cmid, cin, scale=cin ** -0.5),
            rnd(cmid, scale=0.1, dtype=torch.float32),
            rnd(cmid, 3, 3, cmid, scale=(9 * cmid) ** -0.5),
            rnd(cmid, scale=0.1, dtype=torch.float32),
            rnd(cout, cmid, scale=cmid ** -0.5),
            rnd(cout, scale=0.1, dtype=torch.float32)]
    if proj:
        args += [rnd(cout, cin, scale=cin ** -0.5),
                 rnd(cout, scale=0.1, dtype=torch.float32)]
    else:
        args += [None, None]
    return args


def _library_block(args):
    """The same block as a channels-last bf16 cuDNN conv chain (yardstick)."""
    import torch.nn.functional as F

    x, w1, b1, w2, b2, w3, b3, wd, bd = args
    cl = torch.channels_last
    xc = x.permute(0, 3, 1, 2)
    k1 = w1[:, :, None, None].contiguous(memory_format=cl)
    k2 = w2.permute(0, 3, 1, 2).contiguous(memory_format=cl)
    k3 = w3[:, :, None, None].contiguous(memory_format=cl)
    kd = None if wd is None else wd[:, :, None, None].contiguous(
        memory_format=cl)
    b1h, b2h, b3h = (b.to(torch.bfloat16) for b in (b1, b2, b3))
    bdh = None if bd is None else bd.to(torch.bfloat16)

    def run():
        y = torch.relu(F.conv2d(xc, k1, b1h))
        y = torch.relu(F.conv2d(y, k2, b2h, padding=1))
        y = F.conv2d(y, k3, b3h)
        res = xc if kd is None else F.conv2d(xc, kd, bdh)
        return torch.relu(y + res)

    return run


def block_cost(n, h, w, cin, cmid, cout, proj):
    """(FLOPs, bytes) of one block: FLOPs as the JAX kernel's cost estimate
    counts them; bytes = x read once + out written once + weights + biases."""
    flops = 2 * n * h * w * (cin * cmid + 9 * cmid * cmid + cmid * cout
                             + (cin * cout if proj else 0))
    weights = cin * cmid + 9 * cmid * cmid + cmid * cout \
        + (cin * cout if proj else 0)
    biases = 2 * cmid + cout + (cout if proj else 0)
    nbytes = 2 * n * h * w * (cin + cout) + 2 * weights + 4 * biases
    return flops, nbytes


def phase_kernels(label):
    """Each kernel against its plain version; returns the JSON entries."""
    from geoestimation_tpu_torch.ops.fused_bottleneck import (
        fused_bottleneck,
        fused_bottleneck_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
              "flop_ms": 0.0, "byte_ms": 0.0}
    max_err = 0.0
    for shape in MAIN_SHAPES + [RAGGED_SHAPE]:
        name, n, h, w, cin, cmid, cout, proj, per_fwd = shape
        args = _block_inputs(n, h, w, cin, cmid, cout, proj, gen)
        got = fused_bottleneck(*args)
        torch.cuda.synchronize()
        ref = fused_bottleneck_reference(*args)
        g, r = got.float(), ref.float()
        err = float((g - r).abs().max())
        bitwise = float((g == r).float().mean())
        close = bool(torch.allclose(g, r, rtol=KERNEL_RTOL, atol=KERNEL_ATOL))
        max_err = max(max_err, err)
        if not (close and bitwise >= KERNEL_MIN_BITWISE
                and torch.isfinite(g).all()):
            raise RuntimeError(
                f"fused_bottleneck disagrees with its plain version at "
                f"{name}: max_abs_err {err}, bitwise {bitwise:.4f}, "
                f"allclose(rtol={KERNEL_RTOL}, atol={KERNEL_ATOL}) {close}")
        line = {"kernel": "fused_bottleneck", "shape": name,
                "N": n, "max_abs_err": err, "bitwise_equal": bitwise}
        if per_fwd:
            flops, nbytes = block_cost(n, h, w, cin, cmid, cout, proj)
            ms = time_ms(lambda: fused_bottleneck(*args))
            plain = time_ms(lambda: fused_bottleneck_reference(*args))
            lib = time_ms(_library_block(args))
            flop_ms, byte_ms = 1e3 * flops / H100_BF16_FLOPS, \
                1e3 * nbytes / H100_BYTES_PER_S
            line.update(kernel_ms=ms, bound_ms=max(flop_ms, byte_ms),
                        bound_by="bytes" if byte_ms >= flop_ms
                        else "operations",
                        library_ms=lib, plain_ms=plain,
                        launches_per_forward=per_fwd, card=label)
            for key, val in (("ms", ms), ("plain_ms", plain),
                             ("library_ms", lib), ("flop_ms", flop_ms),
                             ("byte_ms", byte_ms)):
                totals[key] += per_fwd * val
        log("kernel-check " + json.dumps(line))
        del args, got, ref, g, r
    return [{
        "name": "fused_bottleneck",
        "route": "cuda",
        "source": "geoestimation_tpu_torch/csrc/fused_bottleneck.cu",
        "replaces": "geoestimation_tpu/ops/fused_bottleneck.py:234",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max_err,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": max(totals["flop_ms"], totals["byte_ms"]),
        "bound_by": ("bytes" if totals["byte_ms"] >= totals["flop_ms"]
                     else "operations"),
        "library_ms": totals["library_ms"],
    }]


# -- phase 3 -------------------------------------------------------------------

REAL_CLASS_COUNTS = (3298, 7202, 12893)   # coarse/middle/fine, published
ARCH = "resnet50"
FAST_RTOL, FAST_ATOL = 0.15, 0.2          # as tests/test_fast_infer.py:110


def seeded_partitionings(rng, counts=REAL_CLASS_COUNTS):
    """Three nested S2 partitionings at the published class counts: coarse
    level-6 cells under random points, then children of chosen cells, so
    every fine cell has an ancestor in each coarser partitioning."""
    from geoestimation_tpu_torch.geo import Partitioning, s2

    n = 4 * counts[0] * 3
    lat = np.degrees(np.arcsin(rng.uniform(-1, 1, n)))
    lng = rng.uniform(-180, 180, n)
    ids = rng.choice(np.unique(s2.cell_id_at_level(lat, lng, 6)), counts[0],
                     replace=False)
    parts = []
    for name, k in zip(("coarse", "middle", "fine"), counts):
        if parts:
            ids = rng.choice(s2.children(parts[-1].cell_ids).ravel(), k,
                             replace=False)
        clat, clng = s2.cell_id_to_latlng(ids)
        parts.append(Partitioning(name=name, tokens=s2.id_to_token(ids),
                                  lat=clat, lng=clng,
                                  counts=np.zeros(k, np.int64)))
    return parts


def seeded_jax_variables(rng, arch, n_classes):
    """Random weights in the JAX package's tree layout (numpy): He-normal
    HWIO kernels, BatchNorm with unit-scale statistics and small residual
    scales (bn3) so 16 blocks stay in range."""
    from geoestimation_tpu_torch.models.resnet import FEATURE_DIM, STAGE_SIZES

    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std))

    def conv(k, cin, cout):
        return {"kernel": normal((k, k, cin, cout), (2.0 / (k * k * cin)) ** .5)}

    def bn(c, lo=0.5, hi=1.0):
        return ({"scale": rng.uniform(lo, hi, c).astype(np.float32),
                 "bias": normal((c,), 0.1)},
                {"mean": normal((c,), 0.1),
                 "var": rng.uniform(0.5, 1.5, c).astype(np.float32)})

    params, stats = {"conv1": conv(7, 3, 64)}, {}
    params["bn1"], stats["bn1"] = bn(64)
    cin = 64
    for stage, n_blocks in enumerate(STAGE_SIZES[arch]):
        mid = 64 * 2 ** stage
        for b in range(n_blocks):
            name = f"layer{stage + 1}_block{b}"
            p = {"conv1": conv(1, cin, mid), "conv2": conv(3, mid, mid),
                 "conv3": conv(1, mid, 4 * mid)}
            s = {}
            p["bn1"], s["bn1"] = bn(mid)
            p["bn2"], s["bn2"] = bn(mid)
            p["bn3"], s["bn3"] = bn(4 * mid, 0.1, 0.3)
            if b == 0:
                p["downsample_conv"] = conv(1, cin, 4 * mid)
                p["downsample_bn"], s["downsample_bn"] = bn(4 * mid)
            params[name], stats[name] = p, s
            cin = 4 * mid
    head = {"kernel": normal((FEATURE_DIM, sum(n_classes)),
                             FEATURE_DIM ** -0.5),
            "bias": normal((sum(n_classes),), 0.1)}
    return ({"backbone": params, "heads": {"fused_head": head}},
            {"backbone": stats})


def build_world(seed=SEED, arch=ARCH, counts=REAL_CLASS_COUNTS):
    """(config, state_dict, partitionings) made from `seed`; the weights go
    through the weights bridge from the JAX layout."""
    from geoestimation_tpu_torch.convert import from_jax_variables
    from geoestimation_tpu_torch.utils.config import Config

    rng = np.random.default_rng(seed)
    parts = seeded_partitionings(rng, counts)
    params, stats = seeded_jax_variables(rng, arch, counts)
    config = Config()
    config.model_params.arch = arch
    return config, from_jax_variables(params, stats, arch, counts), parts


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


def _images_per_s(engine, images, reps=5):
    engine.predict_batch(images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.predict_batch(images)   # returns numpy: synchronized
    return reps * len(images) / (time.perf_counter() - t0)


def phase_main_path(label):
    """Returns the fused kernel's launch count on the main path."""
    from geoestimation_tpu_torch.eval.engine import InferenceEngine
    from geoestimation_tpu_torch.ops.fused_bottleneck import fused_bottleneck

    t0 = time.perf_counter()
    config, sd, parts = build_world()
    fast = InferenceEngine(config, sd, partitionings=parts, n_crops=10,
                           dtype=torch.bfloat16, fast=True, use_pallas=True,
                           device="cuda")
    assert fast.hierarchy.valid.all(), "a fine cell lacks an ancestor"
    log(f"main path: {ARCH} heads {REAL_CLASS_COUNTS}, engine built in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 1)
    images = rng.integers(0, 256, (8, 256, 256, 3), dtype=np.uint8)

    fused_bottleneck.launches = 0
    preds = fast.predict_batch(images)
    launches = fused_bottleneck.launches
    log(f"main path: predict_batch(8 images x 10 crops): fused_bottleneck "
        f"launches {launches} (want 6 per forward)")
    if launches != 6:
        raise RuntimeError(f"fused_bottleneck launched {launches} times in "
                           "one forward; the main path has 6 such blocks")
    _check_predictions(fast, preds, len(images))

    module = InferenceEngine(config, sd, partitionings=parts, n_crops=10,
                             dtype=torch.bfloat16, fast=False, device="cuda")
    x = torch.as_tensor(images, device="cuda")
    got, ref = fast.crop_logits(x), module.crop_logits(x)
    ref_preds = module.predict_batch(images)
    agree = []
    for head, g, r in zip(fast.pred_keys, got, ref):
        if not (torch.isfinite(g).all() and g.shape == r.shape
                == (80, g.shape[-1])):
            raise RuntimeError(f"bad logits for head {head}: {g.shape}")
        err = float((g - r).abs().max())
        agree.append(float((g.argmax(-1) == r.argmax(-1)).float().mean()))
        if not torch.allclose(g, r, rtol=FAST_RTOL, atol=FAST_ATOL):
            raise RuntimeError(
                f"fast path disagrees with the module path on head {head}: "
                f"max_abs_err {err} (rtol {FAST_RTOL}, atol {FAST_ATOL})")
        log(f"main path: fast vs module logits, head {g.shape[-1]} classes: "
            f"max_abs_err {err:.4f}, per-crop argmax agreement "
            f"{agree[-1]:.4f}")
    same = {k: float(np.mean(preds[k][0] == ref_preds[k][0])) for k in preds}
    log(f"main path: predicted-class agreement fast vs module {same}")

    # the card's run against the plain version on the CPU, one image
    cpu = InferenceEngine(config, sd, partitionings=parts, n_crops=10,
                          dtype=torch.bfloat16, fast=True, use_pallas=True,
                          device="cpu")
    cpu_logits = cpu.crop_logits(torch.as_tensor(images[:1]))
    for g, r in zip(fast.crop_logits(x[:1]), cpu_logits):
        if not torch.allclose(g.cpu(), r, rtol=FAST_RTOL, atol=FAST_ATOL):
            raise RuntimeError("card and CPU fast paths disagree: max_abs_err "
                               f"{float((g.cpu() - r).abs().max())}")
    log("main path: card vs CPU plain version, 1 image x 10 crops: max_abs_err "
        + ", ".join(f"{float((g.cpu() - r).abs().max()):.4f}" for g, r in
                    zip(fast.crop_logits(x[:1]), cpu_logits)))

    # end to end: the fast path with the kernel, the same folded path on
    # cuDNN convolutions only (yardstick), and the unfolded module path
    folded_cudnn = InferenceEngine(config, sd, partitionings=parts,
                                   n_crops=10, dtype=torch.bfloat16,
                                   fast=True, use_pallas=False, device="cuda")
    batch = rng.integers(0, 256, (64, 256, 256, 3), dtype=np.uint8)
    fused_bottleneck.launches = 0
    fast_ips = _images_per_s(fast, batch)
    per_forward = fused_bottleneck.launches / 6
    module_ips = _images_per_s(module, batch)
    cudnn_ips = _images_per_s(folded_cudnn, batch)
    log("main path throughput " + json.dumps({
        "metric": "predict_batch ten-crop images/s", "batch": 64,
        "fast_pallas": fast_ips, "fast_cudnn_only": cudnn_ips,
        "module_path": module_ips,
        "fused_bottleneck_launches_per_forward": per_forward,
        "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
        "card": label}))
    if per_forward != 6:
        raise RuntimeError(f"{per_forward} launches per forward, want 6")
    return launches


def main():
    t0 = time.perf_counter()
    label = phase_device()
    kernels = phase_kernels(label)
    launches = phase_main_path(label)
    kernels[0]["launches"] = launches
    log(f"card: {label}; wall {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

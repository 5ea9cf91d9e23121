"""A/B timing of the fused-bottleneck CUDA kernels on the card.

    python -m geoestimation_tpu_torch.tools.bench_kernels [case ...]

The counterpart of the JAX package's `tools/bench_kernels.py`, with its case
names and shapes at 640 crops (a batch of 64 images x 10 crops). Each case
times the kernel against the same block as a channels-last bf16 cuDNN conv
chain, both with CUDA events (median of 20 after 3 warm-up calls), checks
the two agree, and prints one JSON line with the card's name and power
limit. Cases:

  layer1       56x56, 256-64-256, identity           (stride-1 kernel)
  layer1ds     56x56, 64-64-256, projection           (stride-1 kernel)
  layer2carry  28x28, 512-128-512, identity           (stride-1 kernel; the
               CUDA kernel takes the 28-wide plane as it is, so the JAX
               case's zero-padded carry width has no counterpart)
  layer2entry  56x56 -> 28x28, 256-128-512             (stride-2 kernel)
  layer3entry  28x28 -> 14x14, 512-256-1024            (stride-2 kernel)
  layer1npi{2,4,8}, layer2npi{2,4,8}: the JAX images-per-tile sweep. The
               CUDA kernels have no images-per-tile, so these repeat layer1
               and layer2carry; their spread is the timing's noise.
  e2e          the whole ten-crop forward at batch 64 (ingest, ResNet50,
               heads, f*) on the seeded full-width world (`tools/world.py`),
               for the unfolded module path and the fast-path variants
               fast-noPallas, fast-L1, fast-L2, fast-L1L2 and fast-L1L2-s2
               (use_pallas_s2). The JAX tool's mirror variants wait for
               mirror TTA (ROADMAP.md Queue 1, 'TTA variants').

With no case named it runs every case but e2e. Each case's line gives the
plan its kernel chose (`ops.fused_bottleneck.kernel_plan`). It runs on a
CUDA card only and raises without one.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..eval.engine import InferenceEngine
from ..models.fast_infer import build_fast_apply
from ..ops.fused_bottleneck import (
    fused_bottleneck,
    fused_bottleneck_s2,
    kernel_plan,
)
from . import world
from .card import bound_ms, card_label, require_cuda, time_ms

# name: (stride, N, H, W, Cin, Cmid, Cout, projection)
CASES = {
    "layer1": (1, 640, 56, 56, 256, 64, 256, False),
    "layer1ds": (1, 640, 56, 56, 64, 64, 256, True),
    "layer2carry": (1, 640, 28, 28, 512, 128, 512, False),
    "layer2entry": (2, 640, 56, 56, 256, 128, 512, True),
    "layer3entry": (2, 640, 28, 28, 512, 256, 1024, True),
}
for _npi in (2, 4, 8):
    CASES[f"layer1npi{_npi}"] = CASES["layer1"]
    CASES[f"layer2npi{_npi}"] = CASES["layer2carry"]

KERNELS = {1: fused_bottleneck, 2: fused_bottleneck_s2}


def block_inputs(n, h, w, cin, cmid, cout, proj, gen):
    """Block inputs from the generator `gen`, on its device, in the kernels'
    layouts: x, w1, b1, w2, b2, w3, b3, wd, bd (wd, bd None without a
    projection)."""
    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        t = torch.randn(shape, generator=gen, device=gen.device) * scale
        return t.to(dtype).contiguous()

    args = [rnd(n, h, w, cin), rnd(cmid, cin, scale=cin ** -0.5),
            rnd(cmid, scale=0.1, dtype=torch.float32),
            rnd(cmid, 3, 3, cmid, scale=(9 * cmid) ** -0.5),
            rnd(cmid, scale=0.1, dtype=torch.float32),
            rnd(cout, cmid, scale=cmid ** -0.5),
            rnd(cout, scale=0.1, dtype=torch.float32)]
    if proj:
        return args + [rnd(cout, cin, scale=cin ** -0.5),
                       rnd(cout, scale=0.1, dtype=torch.float32)]
    return args + [None, None]


def cudnn_chain(args, stride=1):
    """The same block as channels-last bf16 cuDNN convolutions (a 1x1, a 3x3
    at `stride` with pad 1, a 1x1, and the 1x1 projection at `stride` or the
    identity): the yardstick, used nowhere in the port. Returns a
    zero-argument callable giving NCHW channels-last bf16."""
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
        y = torch.relu(F.conv2d(y, k2, b2h, stride=stride, padding=1))
        y = F.conv2d(y, k3, b3h)
        res = xc if kd is None else F.conv2d(xc, kd, bdh, stride=stride)
        return torch.relu(y + res)

    return run


def block_cost(n, h, w, cin, cmid, cout, proj, stride=1):
    """(FLOPs, bytes) of one block: FLOPs as the JAX kernels' cost estimates
    count them; bytes = x read once + out written once + weights + biases."""
    h2, w2 = h // stride, w // stride
    flops = 2 * n * (h * w * cin * cmid + h2 * w2 * (
        9 * cmid * cmid + cmid * cout + (cin * cout if proj else 0)))
    weights = cin * cmid + 9 * cmid * cmid + cmid * cout \
        + (cin * cout if proj else 0)
    biases = 2 * cmid + cout + (cout if proj else 0)
    nbytes = 2 * n * (h * w * cin + h2 * w2 * cout) + 2 * weights \
        + 4 * biases
    return flops, nbytes


def bench_case(name, label, seed=0):
    stride, n, h, w, cin, cmid, cout, proj = CASES[name]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    args = block_inputs(n, h, w, cin, cmid, cout, proj, gen)
    kernel = KERNELS[stride]
    chain = cudnn_chain(args, stride)
    got = kernel(*args).float()
    ref = chain().permute(0, 2, 3, 1).float()
    err = float((got - ref).abs().max())
    # the chain rounds its bias adds and y3 to bf16: a wiring check, as the
    # JAX tool's spot allclose against XLA (atol 0.25, rtol 0.1)
    ok = bool(torch.allclose(got, ref, rtol=0.1, atol=0.25))
    del got, ref
    ms = time_ms(lambda: kernel(*args))
    cudnn_ms = time_ms(chain)
    bound, bound_by = bound_ms(*block_cost(n, h, w, cin, cmid, cout, proj,
                                           stride))
    line = {"case": name, "kernel": kernel.__name__, "N": n,
            "shape": f"{h}x{w} {cin}-{cmid}-{cout}"
                     + (" proj" if proj else ""),
            **kernel_plan(kernel.__name__, n, h, w, cin, cmid, cout, proj),
            "kernel_ms": ms, "cudnn_ms": cudnn_ms, "speedup": cudnn_ms / ms,
            "bound_ms": bound, "bound_by": bound_by,
            "max_abs_err_vs_cudnn": err, "allclose": ok, "card": label}
    print("bench_kernels " + json.dumps(line), flush=True)
    if not ok:
        raise RuntimeError(f"{name}: the kernel disagrees with the cuDNN "
                           f"chain (max abs err {err})")


# The fast-path variants of e2e (and of bench_stages): build_fast_apply
# keywords by name.
FAST_VARIANTS = {
    "fast-noPallas": dict(use_pallas=False, pallas_stages={}),
    "fast-L1": dict(use_pallas=True, pallas_stages={0: 1}),
    "fast-L2": dict(use_pallas=True, pallas_stages={1: 2}),
    "fast-L1L2": dict(use_pallas=True, pallas_stages={0: 1, 1: 2}),
    "fast-L1L2-s2": dict(use_pallas=True, pallas_stages={0: 1, 1: 2},
                         use_pallas_s2=True),
}


def bench_e2e(label, batch=64, reps=10):
    config, sd, parts = world.build_world()
    module = InferenceEngine(config, sd, partitionings=parts, n_crops=10,
                             dtype=torch.bfloat16, fast=False, device="cuda")
    rng = np.random.default_rng(world.SEED)
    images = torch.as_tensor(
        rng.integers(0, 256, (batch, 256, 256, 3), dtype=np.uint8),
        device="cuda")
    variants = [("module", module.model)] + [
        (name, build_fast_apply(sd, world.ARCH,
                                n_classes=world.REAL_CLASS_COUNTS,
                                device="cuda", **kw))
        for name, kw in FAST_VARIANTS.items()]
    for name, apply in variants:
        run = world.forward(apply, module.harrays)
        fused_bottleneck.launches = fused_bottleneck_s2.launches = 0
        run(images)
        launches = (fused_bottleneck.launches, fused_bottleneck_s2.launches)
        ms = time_ms(lambda: run(images), reps=reps)
        line = {"variant": name, "batch": batch, "ms_per_step": ms,
                "images_per_s": batch / (ms / 1e3),
                "fused_bottleneck_launches": launches[0],
                "fused_bottleneck_s2_launches": launches[1], "card": label}
        print("bench_kernels " + json.dumps(line), flush=True)


def main(argv=None):
    names = list(sys.argv[1:] if argv is None else argv) or [
        n for n in CASES]
    unknown = [n for n in names if n != "e2e" and n not in CASES]
    if unknown:
        raise SystemExit(f"unknown case(s) {unknown}; have "
                         f"{list(CASES) + ['e2e']}")
    require_cuda("bench_kernels")
    label = card_label()
    print(f"card: {label}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    for name in names:
        if name == "e2e":
            bench_e2e(label)
        else:
            bench_case(name, label)


if __name__ == "__main__":
    main()

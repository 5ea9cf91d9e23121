"""A/B timing of the port's CUDA kernels on the card.

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
  conv_s8      the int8 convolution at every distinct convolution of the
               int8 ResNet50 (`int8_conv_shapes`, 28 shapes) at 640 crops;
               conv_s8_n80 the same at 80 crops (`chip_smoke.py`'s size).
               Each shape is checked bit for bit against the plain version
               and timed beside its bound and one int8 GEMM on the same
               inputs: `torch._int_mm` of the pixels by the weights for a
               1x1 stride-1 convolution, im2col first for the others; a
               last line sums each column over the 53 launches of a forward.
               `kernel_ms` times one launch from an idle card (the host's
               work to launch it included); `queued_ms` is the mean of 10
               launches issued back to back, as a forward issues them.
  e2e          the whole ten-crop forward at batch 64 (ingest, ResNet50,
               heads, f*) on the seeded full-width world (`tools/world.py`),
               for the unfolded module path, the fast-path variants
               fast-noPallas, fast-L1, fast-L2, fast-L1L2 and fast-L1L2-s2
               (use_pallas_s2), and the JAX tool's mirror-TTA variants
               mirror-noPallas and mirror-L2 (five crops through the network
               and its W-mirror, `build_mirror_tta_apply`).

With no case named it runs every case but e2e. Each case's line gives the
plan its kernel chose (`ops.fused_bottleneck.kernel_plan`,
`ops.conv_s8.kernel_plan`). It runs on a
CUDA card only and raises without one.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..eval.engine import InferenceEngine
from ..eval.infer import mean_tta_logits, predict_all
from ..models.fast_infer import build_fast_apply, build_mirror_tta_apply
from ..models.resnet import STAGE_SIZES
from ..ops import conv_s8 as ops8
from ..ops.fused_bottleneck import (
    fused_bottleneck,
    fused_bottleneck_s2,
    kernel_plan,
)
from . import world
from .card import H100_INT8_OPS, bound_ms, card_label, require_cuda, time_ms

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


# The JAX tool's mirror-TTA variants: pallas_stages by name.
MIRROR_VARIANTS = {"mirror-noPallas": {}, "mirror-L2": {1: 2}}


def int8_conv_shapes(n=80, arch="resnet50", crop=224):
    """[(label, (N, H, Cin, Cout, K, stride, pad, out_hw, lo, res_mode),
    launches per forward)] of every distinct convolution of the int8
    ResNet50 at `crop`-px crops, N crops: the stem over its space-to-depth
    buffer, and each block's 1x1, 3x3 and conv3 (the stage entries' conv3
    requantized alone, their downsample conv with the entry residual; the
    identity blocks' conv3 with the identity residual)."""
    shapes = {}

    def add(label, key):
        shapes.setdefault(key, [label, 0])[1] += 1

    add("stem 4x4 space-to-depth", (n, (crop + 8) // 2, 16, 64, 4, 1, 0,
                                     (crop // 2, crop // 2), 0.0, None))
    h, cin = crop // 4, 64
    for stage, n_blocks in enumerate(STAGE_SIZES[arch]):
        mid, layer = 64 * 2 ** stage, f"layer{stage + 1}"
        for b in range(n_blocks):
            s = 2 if stage > 0 and b == 0 else 1
            ho = (h - 1) // s + 1
            add(f"{layer} conv1 1x1 {cin}-{mid} @{h}",
                (n, h, cin, mid, 1, 1, 0, None, 0.0, None))
            add(f"{layer} conv2 3x3/{s} {mid} @{h}",
                (n, h, mid, mid, 3, s, 1, None, 0.0, None))
            if b == 0:
                add(f"{layer} conv3 1x1 {mid}-{4 * mid} signed @{ho}",
                    (n, ho, mid, 4 * mid, 1, 1, 0, None, -127.0, None))
                add(f"{layer} downsample 1x1/{s} {cin}-{4 * mid} + entry "
                    f"residual @{h}", (n, h, cin, 4 * mid, 1, s, 0, None, 0.0,
                                      "mul_add"))
            else:
                add(f"{layer} conv3 1x1 {mid}-{4 * mid} + identity residual "
                    f"@{ho}", (n, ho, mid, 4 * mid, 1, 1, 0, None, 0.0,
                               "fma"))
            h, cin = ho, 4 * mid
    return [(label, key, count) for key, (label, count) in shapes.items()]


INT8_LAUNCHES = 53      # one per convolution of the int8 ResNet50
STEM_S2D_CIN = 12       # the stem's space-to-depth channels, before padding
# the kernel's edges, not on the main path: M and Cout short of a tile, rne
INT8_EDGES = [("ragged 9x9/2 32-24 rne + identity residual",
               (3, 9, 32, 24, 3, 2, 1, None, 0.0, "fma"), 0),
              ("tiny 5x5 16-8 signed + entry residual",
               (1, 5, 16, 8, 1, 1, 0, None, -127.0, "mul_add"), 0)]


def conv_s8_inputs(key, gen):
    """Seeded inputs of one `int8_conv_shapes` entry on the generator's
    device: ((x, w, mult, bias), keywords of `conv_s8`)."""
    n, h, cin, cout, k, s, p, out_hw, lo, res_mode = key
    ho, wo = out_hw or ops8.out_size(h, h, (k, k), s, p)

    def i8(shape, lo_, hi):
        return torch.randint(lo_, hi, shape, generator=gen, device=gen.device,
                             dtype=torch.int32).to(torch.int8)

    # the stem sees (pixel - 128); every other input is post-relu
    x = i8((n, h, h, cin), -128 if k == 4 else 0, 128)
    w = i8((cout, k * k * cin), -127, 128)
    mult = torch.rand(cout, generator=gen, device=gen.device) * 2e-3 + 1e-5
    bias = torch.randn(cout, generator=gen, device=gen.device) * 20
    res = i8((n, ho, wo, cout), -127 if res_mode == "mul_add" else 0,
             128) if res_mode else None
    return (x, w, mult, bias), dict(
        ksize=(k, k), stride=s, pad=p, out_hw=out_hw, lo=lo, res=res,
        res_scale=0.37, res_mode=res_mode or "fma")


def _taps_reach(size, out, k, stride, pad):
    """How many of an input's `size` rows (or columns) the taps of `out`
    output rows read: all of them where k >= stride, one in `stride` for
    a strided 1x1 convolution."""
    return len({o * stride + t - pad for o in range(out) for t in range(k)}
               & set(range(size)))


def conv_s8_cost(key):
    """(operations, bytes) of one convolution: 2 per multiply-add; each
    input byte that a tap reads, each residual and weight byte read once,
    each output byte written once, mult and bias 8 bytes a channel. The
    stem counts the function's 12 space-to-depth channels, not the 16 it is
    launched with (4 of them zeros the kernel needs for Cin % 16 == 0)."""
    n, h, cin, cout, k, s, p, out_hw, _, res_mode = key
    ho, wo = out_hw or ops8.out_size(h, h, (k, k), s, p)
    cin = STEM_S2D_CIN if k == 4 else cin
    out = n * ho * wo * cout
    x_bytes = (n * _taps_reach(h, ho, k, s, p) * _taps_reach(h, wo, k, s, p)
               * cin)
    return (2 * out * k * k * cin,
            x_bytes + cout * k * k * cin + 8 * cout
            + out * (2 if res_mode else 1))


def _im2col(x, k, stride, pad, out_hw):
    """(N*Ho*Wo, K*K*Cin) int8 columns of an NHWC int8 tensor, (ky, kx, c)
    order: the input of the library yardstick's int8 GEMM."""
    n, h, w, c = x.shape
    ho, wo = out_hw
    xp = torch.zeros((n, h + 2 * pad, w + 2 * pad, c), dtype=x.dtype,
                     device=x.device)
    xp[:, pad:pad + h, pad:pad + w] = x
    taps = [xp[:, ky:ky + stride * (ho - 1) + 1:stride,
               kx:kx + stride * (wo - 1) + 1:stride]
            for ky in range(k) for kx in range(k)]
    return torch.stack(taps, dim=3).reshape(n * ho * wo, k * k * c)


def conv_s8_library(args, kw):
    """(name, zero-argument callable): one int8 GEMM on the same inputs, the
    yardstick, used nowhere in the port. A 1x1 stride-1 convolution is the
    matrix product of its pixels (N*H*W, Cin) by the weights, with no copy;
    a strided or larger one needs its im2col columns first."""
    x, w = args[0], args[1]
    k, s, p = kw["ksize"][0], kw["stride"], kw["pad"]
    wt = w.t()
    if k == 1 and s == 1 and p == 0 and kw["out_hw"] is None:
        a = x.view(-1, x.shape[-1])
        return "torch._int_mm", lambda: torch._int_mm(a, wt)
    out_hw = kw["out_hw"] or ops8.out_size(x.shape[1], x.shape[2], (k, k), s,
                                           p)
    return "im2col + torch._int_mm", lambda: torch._int_mm(
        _im2col(x, k, s, p, out_hw), wt)


def conv_s8_plan(x, w, kw):
    """The kernel's plan for these inputs (`ops.conv_s8.kernel_plan`)."""
    n, h, wd, cin = x.shape
    k, s, p = kw["ksize"][0], kw["stride"], kw["pad"]
    ho, wo = kw["out_hw"] or ops8.out_size(h, wd, (k, k), s, p)
    return ops8.kernel_plan(n, h, wd, cin, ho, wo, w.shape[0], k, k, s, p,
                            kw["res"] is not None)


def bench_conv_s8(label, n, seed=0):
    """Every `int8_conv_shapes` entry at N crops: bit-equal to the plain
    version, then kernel, bound and library times; one line per shape and
    one summed over a forward's launches."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    totals = {"kernel_ms": 0.0, "queued_ms": 0.0, "library_ms": 0.0, "ops": 0,
              "bytes": 0}
    for shape, key, per_fwd in int8_conv_shapes(n):
        args, kw = conv_s8_inputs(key, gen)
        got = ops8.conv_s8(*args, **kw)
        equal = bool(torch.equal(got, ops8.conv_s8_reference(*args, **kw)))
        del got
        ms = time_ms(lambda: ops8.conv_s8(*args, **kw))
        queued = time_ms(lambda: [ops8.conv_s8(*args, **kw)
                                  for _ in range(QUEUED)]) / QUEUED
        lib_name, lib = conv_s8_library(args, kw)
        lib_ms = time_ms(lib)
        nops, nbytes = conv_s8_cost(key)
        bound, bound_by = bound_ms(nops, nbytes, H100_INT8_OPS)
        print("bench_kernels " + json.dumps({
            "case": "conv_s8", "shape": shape, "N": n,
            "plan": conv_s8_plan(args[0], args[1], kw), "kernel_ms": ms,
            "queued_ms": queued,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
            "library": lib_name, "launches_per_forward": per_fwd,
            "bit_equal": equal, "card": label}), flush=True)
        if not equal:
            raise RuntimeError(f"conv_s8 differs from its plain version at "
                               f"{shape}, N = {n}")
        for key_, val in (("kernel_ms", ms), ("queued_ms", queued),
                          ("library_ms", lib_ms),
                          ("ops", nops), ("bytes", nbytes)):
            totals[key_] += per_fwd * val
        del args, kw
    bound, bound_by = bound_ms(totals.pop("ops"), totals.pop("bytes"),
                               H100_INT8_OPS)
    print("bench_kernels " + json.dumps({
        "case": "conv_s8 forward", "N": n, "launches": INT8_LAUNCHES,
        **totals, "bound_ms": bound, "bound_by": bound_by,
        "card": label}), flush=True)


CONV_S8_CASES = {"conv_s8": 640, "conv_s8_n80": 80}
QUEUED = 10     # launches back to back for `queued_ms`: the host's share hidden


def bench_e2e(label, batch=64, reps=10):
    config, sd, parts = world.build_world()
    module = InferenceEngine(config, sd, partitionings=parts, n_crops=10,
                             dtype=torch.bfloat16, fast=False, device="cuda")
    rng = np.random.default_rng(world.SEED)
    images = torch.as_tensor(
        rng.integers(0, 256, (batch, 256, 256, 3), dtype=np.uint8),
        device="cuda")
    kw = dict(n_classes=world.REAL_CLASS_COUNTS, device="cuda")
    variants = [("module", world.forward(module.model, module.harrays))] + [
        (name, world.forward(build_fast_apply(sd, world.ARCH, **kw, **v),
                             module.harrays))
        for name, v in FAST_VARIANTS.items()]
    # mirror TTA takes the uint8 batch and cuts its own crops
    for name, stages in MIRROR_VARIANTS.items():
        mirror = build_mirror_tta_apply(sd, world.ARCH, **kw,
                                        use_pallas=bool(stages),
                                        pallas_stages=stages)
        variants.append((name, torch.inference_mode()(
            lambda x, mirror=mirror: predict_all(
                [mean_tta_logits(l, 10) for l in mirror(x)],
                module.harrays))))
    for name, run in variants:
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
        *CASES, *CONV_S8_CASES]
    have = list(CASES) + list(CONV_S8_CASES) + ["e2e"]
    unknown = [n for n in names if n not in have]
    if unknown:
        raise SystemExit(f"unknown case(s) {unknown}; have {have}")
    require_cuda("bench_kernels")
    label = card_label()
    print(f"card: {label}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    for name in names:
        if name == "e2e":
            bench_e2e(label)
        elif name in CONV_S8_CASES:
            bench_conv_s8(label, CONV_S8_CASES[name])
        else:
            bench_case(name, label)


if __name__ == "__main__":
    main()

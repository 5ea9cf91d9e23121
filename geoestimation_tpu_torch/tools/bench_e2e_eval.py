"""End-to-end eval throughput with host ingest: JPEG files to predictions.

    python -m geoestimation_tpu_torch.tools.bench_e2e_eval \\
        [--image_dir DIR] [--n_images 1024] [--img_size 0] \\
        [--batch_size 64] [--crops 1|5|10] [--precision int8|bf16] \\
        [--arch resnet50] [--num_workers N] [--fast_decode] [--json OUT] \\
        [--cpu]

The port of the JAX package's `tools/bench_e2e_eval.py`, with its flags and
its result keys. It drives the real folder pipeline: JPEG files on disk ->
`data.image_folder.iter_image_folder` (decode in a background thread,
overlapping the device) -> the device forward (uint8 base batch -> device
ingest -> the network -> `mean_tta_logits` -> f* over three partitionings at
the published class counts, on seeded ancestor maps), and prints one JSON
line:

  * end-to-end images/s (wall clock over the whole corpus),
  * the device-busy share (the sum of each batch's fenced device time over
    the wall) and images/s over that device time (transfers included),
  * the device-resident images/s (one batch kept on the device),
  * the host's decode rate on one core, and the host cores one card needs
    so that decode keeps up with it (device-resident rate / decode rate
    per core).

`--precision int8` (the default) runs the int8 network (`models/quant.py`,
every convolution on the `conv_s8` kernel: 53 launches a forward),
calibrated (absmax) on 8 seeded images; `bf16` runs the classifier module's
forward on cuDNN, as the JAX tool runs `model.apply`. The weights are
random, made from seed 0 in the JAX package's layout as `tools/world.py`
makes them (residual branches scaled so 16 blocks stay in range) and passed
through the weights bridge (`convert.from_jax_variables`). Each batch's
device time ends with a synchronization of the card. Runs on CUDA unless
--cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from .world import REAL_CLASS_COUNTS

CROP = 224
NAMES = ("coarse", "middle", "fine")


def generate_corpus(out_dir, n_images, seed=0, img_size=0):
    """n_images textured JPEGs (`tools.make_demo_world.textured_image`):
    varied content at a real photo's decode cost, byte for byte the JAX
    tool's. img_size=0 keeps the small near-base sizes (256-340 px);
    img_size=N writes ~N-px photos (about 1024 for a Flickr photo's decode
    cost, where --fast_decode pays)."""
    from .make_demo_world import textured_image

    rng = np.random.default_rng(seed)
    if img_size:
        s = img_size
        sizes = [(s, s * 3 // 4), (s * 3 // 4, s), (s, s * 2 // 3),
                 (s * 7 // 8, s * 7 // 8)]
    else:
        sizes = [(320, 280), (340, 256), (280, 300), (256, 256)]
    for i in range(n_images):
        w, h = sizes[i % len(sizes)]
        blob = textured_image(rng, i % 3, i % 4, w, h)
        with open(os.path.join(out_dir, f"img_{i:05d}.jpg"), "wb") as f:
            f.write(blob)


def synthetic_harrays(n_classes, device):
    """Hierarchy arrays with seeded random valid ancestor maps, of the shapes
    and device cost of maps built from real cell files (the JAX package's
    `__graft_entry__._synthetic_harrays`)."""
    from ..eval.infer import HierarchyArrays

    rng = np.random.default_rng(0)
    n_fine = n_classes[-1]
    maps = tuple(np.sort(rng.integers(0, n, n_fine)) if n != n_fine
                 else np.arange(n_fine) for n in n_classes)
    lats = tuple(rng.uniform(-60, 70, n) for n in n_classes)
    lngs = tuple(rng.uniform(-180, 180, n) for n in n_classes)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return HierarchyArrays(
        maps=tuple(torch.as_tensor(m, dtype=torch.int64, device=device)
                   for m in maps),
        valid=torch.ones(n_fine, dtype=torch.bool, device=device),
        lats=tuple(map(f32, lats)), lngs=tuple(map(f32, lngs)), names=NAMES)


def build_forward(arch, precision, n_crops, device):
    """`forward(images_u8) -> (class, lat, lng)` of f* for a uint8 base
    batch on `device`, on seeded weights (module docs)."""
    from ..convert import from_jax_variables
    from ..eval.engine import resolve_device
    from ..eval.infer import mean_tta_logits, predict_hierarchical
    from ..ingest.pipeline import eval_pipeline, eval_pipeline_s8
    from ..models import quant
    from ..models.classifier import MultiPartitioningClassifier
    from .world import seeded_jax_variables

    device = resolve_device(device)
    sd = from_jax_variables(*seeded_jax_variables(
        np.random.default_rng(0), arch, REAL_CLASS_COUNTS), arch,
        REAL_CLASS_COUNTS)
    harrays = synthetic_harrays(REAL_CLASS_COUNTS, device)

    if precision == "int8":
        calib = np.random.default_rng(123).integers(
            0, 255, (8, 256, 256, 3), dtype=np.uint8)
        scales = quant.calibrate(sd, [calib], arch=arch, n_crops=n_crops,
                                 crop=CROP, device=device)
        int8_apply = quant.build_int8_apply(
            quant.quantize_model(sd, arch=arch), scales,
            n_classes=REAL_CLASS_COUNTS, device=device)

        def logits(images_u8):
            return int8_apply(eval_pipeline_s8(images_u8, n_crops=n_crops,
                                               crop=CROP))
    else:
        with torch.device("meta"):
            net = MultiPartitioningClassifier(REAL_CLASS_COUNTS, arch,
                                              torch.bfloat16)
        net.load_state_dict(sd, strict=True, assign=True)
        net = net.to(device, memory_format=torch.channels_last).eval()

        def logits(images_u8):
            return net(eval_pipeline(images_u8, n_crops=n_crops, crop=CROP,
                                     dtype=torch.bfloat16))

    @torch.inference_mode()
    def forward(images_u8):
        return predict_hierarchical(
            [mean_tta_logits(l, n_crops) for l in logits(images_u8)],
            harrays)

    return forward


def _fence(out):
    """Waits for the forward that gave `out`: one value read back."""
    out[0][:1].cpu()


def main(argv=None):
    p = argparse.ArgumentParser(
        description="e2e eval throughput incl. host ingest")
    p.add_argument("--image_dir", default=None,
                   help="existing corpus (default: generate one)")
    p.add_argument("--n_images", type=int, default=1024)
    p.add_argument("--img_size", type=int, default=0,
                   help="generated-corpus photo size (0: historical "
                        "256-340 px; ~1024 for Flickr-typical)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--crops", type=int, default=10, choices=[1, 5, 10])
    p.add_argument("--precision", default="int8", choices=["int8", "bf16"])
    p.add_argument("--arch", default="resnet50")
    p.add_argument("--num_workers", type=int, default=None,
                   help="decode threads (default: cpu count)")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--fast_decode", action="store_true",
                   help="scaled DCT JPEG decode (ingest.decode fast_scale)"
                        " — the production host-ingest mode for large "
                        "photos; measured alongside the budget numbers")
    p.add_argument("--json", dest="json_out", default=None)
    args = p.parse_args(argv)

    from ..data.image_folder import iter_image_folder
    from ..eval.engine import resolve_device
    from ..ingest import decode

    device = resolve_device("cpu" if args.cpu else "cuda")
    tmp = None
    image_dir = args.image_dir
    if image_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="e2e_corpus_")
        image_dir = tmp.name
        t0 = time.perf_counter()
        generate_corpus(image_dir, args.n_images, img_size=args.img_size)
        print(f"generated {args.n_images} JPEGs in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)

    forward = build_forward(args.arch, args.precision, args.crops, device)

    def batches():
        return iter_image_folder(image_dir, batch_size=args.batch_size,
                                 num_workers=args.num_workers,
                                 fast_decode=args.fast_decode)

    # warm-up on one batch: kernel builds, cuDNN's plans, the allocator
    for fb in batches():
        _fence(forward(torch.as_tensor(fb.images).to(device)))
        break

    # the host's own decode rate on one core
    paths = sorted(os.listdir(image_dir))[:min(256, args.n_images)]
    blobs = decode.read_files([os.path.join(image_dir, p) for p in paths])
    t0 = time.perf_counter()
    decode.decode_batch(blobs, resize_to=256, base_size=256, num_threads=1,
                        fast_scale=args.fast_decode)
    decode_rate_1core = len(blobs) / (time.perf_counter() - t0)

    # the measured run: the folder pipeline's decode prefetch overlapping
    # the device; each batch's device time (its copy to the device
    # included) ends with a read-back of one value
    n_done = 0
    device_busy = 0.0
    wall0 = time.perf_counter()
    for fb in batches():
        t0 = time.perf_counter()
        _fence(forward(torch.as_tensor(fb.images).to(device)))
        device_busy += time.perf_counter() - t0
        n_done += int(np.asarray(fb.valid).sum())
    wall = time.perf_counter() - wall0

    # device-resident: the last batch kept on the device, no copy a step
    dev_images = torch.as_tensor(fb.images).to(device)
    _fence(forward(dev_images))
    t0 = time.perf_counter()
    for _ in range(10):
        out = forward(dev_images)
    _fence(out)
    resident_rate = 10 * fb.images.shape[0] / (time.perf_counter() - t0)

    device_rate = n_done / device_busy if device_busy else float("nan")
    e2e_rate = n_done / wall
    result = {
        "metric": "e2e_eval_images_per_sec",
        "value": round(e2e_rate, 2),
        "unit": "images/sec (incl. host ingest)",
        "n_images": n_done,
        "batch_size": args.batch_size,
        "crops": args.crops,
        "precision": args.precision,
        "fast_decode": bool(args.fast_decode),
        "img_size": args.img_size,
        "arch": args.arch,
        "platform": device.type,
        "device_busy_frac": round(device_busy / wall, 4),
        "device_plus_transfer_images_per_sec": round(device_rate, 2),
        "device_resident_images_per_sec": round(resident_rate, 2),
        "host_decode_images_per_sec_per_core": round(decode_rate_1core, 2),
        "host_cores_per_chip_budget": round(
            resident_rate / decode_rate_1core, 2),
    }
    print(json.dumps(result), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=1)
    if tmp:
        tmp.cleanup()
    return result


if __name__ == "__main__":
    main()

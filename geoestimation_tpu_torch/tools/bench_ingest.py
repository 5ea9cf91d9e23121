"""Host-ingest throughput: JPEG decode to a 256x256 uint8 base, on the host.

    python -m geoestimation_tpu_torch.tools.bench_ingest [--n 256] \\
        [--iters 5] [--threads N] [--width 320] [--height 280] \\
        [--content photo|noise]

The port of the JAX package's `tools/bench_ingest.py`, with its flags and
output lines. It times `ingest.decode.decode_batch` on synthetic JPEGs of
the documented eval geometry (the same bytes as the JAX tool's for the same
arguments) for each backend: the native libjpeg decoder (`turbo`) where
`ingest/native.py` builds it, and PIL always, each with and without scaled
DCT decode (`fast_scale`). It prints one line per backend and mode: images/s
on this host, per core and over all of its cores. The eval pipelines overlap
host decode with the device's forward (`data/image_folder.py` prefetch), so
a folder run is device-bound as long as decode outruns the card. Runs no
device code and needs no card.
"""

from __future__ import annotations

import argparse
import io
import os
import time

import numpy as np


def make_jpegs(n, size=(320, 280), quality=90, seed=0, content="photo"):
    """n seeded JPEG blobs of `size` (w, h). content='photo': smooth
    multi-scale structure, a real photo's JPEG entropy; content='noise':
    uniform noise, the worst case for JPEG size and entropy-decode cost (a
    pessimistic bound)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    w, h = size
    blobs = []
    for _ in range(n):
        if content == "noise":
            arr = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        else:
            y, x = np.mgrid[0:h, 0:w].astype(np.float32)
            f1, f2 = rng.uniform(60, 200), rng.uniform(90, 260)
            p1, p2 = rng.uniform(0, 6.3, 2)
            base = np.stack([
                127 + 110 * np.sin(x / f1 + p1) * np.cos(y / f2 + p2),
                127 + 110 * np.cos(x / f2 + p2) * np.sin(y / f1),
                (x + y) * (255.0 / (w + h)),
            ], -1)
            texture = rng.normal(0, 12, (h // 4 + 1, w // 4 + 1, 3))
            texture = np.repeat(np.repeat(texture, 4, 0), 4, 1)[:h, :w]
            arr = np.clip(base + texture, 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
        blobs.append(buf.getvalue())
    return blobs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--threads", type=int, default=None)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=280,
                   help="source JPEG dims; use e.g. --width 1024 "
                        "--height 768 for realistic Flickr photos where "
                        "scaled decode pays off")
    p.add_argument("--content", default="photo", choices=["photo", "noise"],
                   help="photo: realistic smooth JPEGs; noise: "
                        "pessimistic entropy-decode bound")
    args = p.parse_args(argv)

    from ..ingest import decode

    blobs = make_jpegs(args.n, size=(args.width, args.height),
                       content=args.content)
    cores = os.cpu_count() or 1
    kb = sum(len(b) for b in blobs) / len(blobs) / 1024
    results = []
    for backend in (["turbo"] if decode.native.available() else []) + ["pil"]:
        for fast in (False, True):
            # warm-up: the thread pool's start and first page faults
            decode.decode_batch(blobs[:16], backend=backend,
                                num_threads=args.threads, fast_scale=fast)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                out, ok = decode.decode_batch(blobs, backend=backend,
                                              num_threads=args.threads,
                                              fast_scale=fast)
            dt = time.perf_counter() - t0
            if not ok.all() or out.shape[1:] != (256, 256, 3):
                raise RuntimeError(f"bench_ingest: {backend} decoded "
                                   f"{int(ok.sum())} of {len(blobs)} blobs "
                                   f"to {out.shape[1:]}")
            ips = args.n * args.iters / dt
            label = backend + ("+fast" if fast else "")
            print(f"{label:11s}: {ips:8.1f} images/sec "
                  f"({ips / cores:.0f}/core x {cores} cores; "
                  f"{args.n} {args.content} blobs of "
                  f"{args.width}x{args.height} (~{kb:.0f} KB) "
                  f"x {args.iters} iters, "
                  f"threads={args.threads or 'auto'})", flush=True)
            results.append({"backend": label, "images_per_sec": ips,
                            "per_core": ips / cores, "cores": cores})
    return results


if __name__ == "__main__":
    main()

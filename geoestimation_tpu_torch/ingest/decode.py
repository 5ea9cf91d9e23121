"""Host-side image decode + geometry normalization (the PIL path).

The port of `geoestimation_tpu/ingest/decode.py` without the native decoder:
the host emits a static-shape uint8 tensor (N, base_size, base_size, 3), and
everything after decode (crops, normalization, dtype) runs on the device
(`ingest/pipeline.py`).

Geometry matches torchvision eval semantics: resize the shorter side to
`resize_to` with bilinear filtering, then center-crop a `base_size` square.
Pillow is imported where an image is decoded.
"""

from __future__ import annotations

import concurrent.futures as cf
import io
import os
from typing import Iterable, Optional, Sequence

import numpy as np

DEFAULT_RESIZE = 256
DEFAULT_BASE = 256
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def decode_pil(data: bytes, resize_to=DEFAULT_RESIZE, base_size=DEFAULT_BASE,
               fast_scale=False):
    """bytes -> (base_size, base_size, 3) uint8.

    fast_scale=True uses PIL's JPEG draft mode (scaled DCT decode): the
    decoder emits the smallest 1/2^k scale covering `resize_to`, and the
    final resize still targets the geometry derived from the ORIGINAL dims
    -- identical shapes, slightly different pixels.
    """
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    w, h = img.size  # header dims, pre-draft: geometry source of truth
    if fast_scale:
        img.draft("RGB", (resize_to, resize_to))
    img = img.convert("RGB")
    scale = resize_to / min(w, h)
    nw, nh = max(int(round(w * scale)), resize_to), max(
        int(round(h * scale)), resize_to
    )
    img = img.resize((nw, nh), Image.BILINEAR)
    left = (nw - base_size) // 2
    top = (nh - base_size) // 2
    img = img.crop((left, top, left + base_size, top + base_size))
    return np.asarray(img, dtype=np.uint8)


def decode_batch(
    blobs: Sequence[bytes],
    resize_to=DEFAULT_RESIZE,
    base_size=DEFAULT_BASE,
    num_threads: Optional[int] = None,
    fast_scale: bool = False,
):
    """Decode many image byte strings -> ((N, base, base, 3) uint8, ok).

    Undecodable blobs yield a zero image and are flagged False in `ok`
    (eval folders may hold rotten downloads).
    """
    n = len(blobs)
    out = np.zeros((n, base_size, base_size, 3), dtype=np.uint8)
    ok = np.zeros(n, dtype=bool)

    def work(i):
        try:
            out[i] = decode_pil(blobs[i], resize_to, base_size,
                                fast_scale=fast_scale)
            ok[i] = True
        except Exception:  # noqa: BLE001 - any undecodable blob is flagged
            pass

    workers = num_threads or min(16, (os.cpu_count() or 1) * 2)
    if n == 1:
        work(0)
    else:
        with cf.ThreadPoolExecutor(workers) as ex:
            list(ex.map(work, range(n)))
    return out, ok


def read_files(paths: Iterable[str]):
    blobs = []
    for p in paths:
        try:
            with open(p, "rb") as f:
                blobs.append(f.read())
        except OSError:
            blobs.append(b"")
    return blobs

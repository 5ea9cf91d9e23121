"""Host-side image decode + geometry normalization.

The port of `geoestimation_tpu/ingest/decode.py`: the host emits a
static-shape uint8 tensor (N, base_size, base_size, 3), and everything after
decode (crops, normalization, dtype) runs on the device
(`ingest/pipeline.py`).

Two host decode backends, routed as in the JAX package:
  * `turbo`: the C++ library of `ingest/cpp/` (`ingest/native.py`: libjpeg,
    bilinear shorter-side resize and center crop in native threads), for
    JPEGs; other formats go to PIL.
  * `pil`: Pillow, threaded (its decode and resize release the GIL).
`auto` is `turbo` where the library builds and loads, else `pil`
(`auto_backend()` says which). The two differ by up to 2 per pixel.

Geometry matches torchvision eval semantics: resize the shorter side to
`resize_to` with bilinear filtering, then center-crop a `base_size` square.
`decode_batch_tencrop` is the torchvision-exact ten-crop of the full resized
rectangle, for `tta_mode="host_exact"`. Pillow is imported where an image is
decoded.
"""

from __future__ import annotations

import concurrent.futures as cf
import io
import os
from typing import Iterable, Optional, Sequence

import numpy as np

from . import native

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


def auto_backend() -> str:
    """The backend `backend="auto"` resolves to here: 'turbo' where the
    native library builds and loads, else 'pil'."""
    return "turbo" if native.available() else "pil"


def decode_batch(
    blobs: Sequence[bytes],
    resize_to=DEFAULT_RESIZE,
    base_size=DEFAULT_BASE,
    num_threads: Optional[int] = None,
    backend: str = "auto",
    fast_scale: bool = False,
):
    """Decode many image byte strings -> ((N, base, base, 3) uint8, ok).

    backend: 'auto' (native where it builds, see `auto_backend`), 'turbo'
    (raises with the compiler's message where the library cannot be
    built), or 'pil'. fast_scale: scaled DCT decode for JPEGs (see
    decode_pil); off on the default parity path.
    Undecodable blobs yield a zero image and are flagged False in `ok`
    (eval folders may hold rotten downloads).
    """
    if backend == "auto":
        backend = auto_backend()
    if backend == "turbo":
        # The native decoder is JPEG-only: other formats (PNG is part of
        # the eval-folder contract) go through PIL, by the JPEG magic bytes.
        is_jpeg = [b[:2] == b"\xff\xd8" for b in blobs]
        if all(is_jpeg):
            return native.decode_batch(blobs, resize_to, base_size,
                                       num_threads=num_threads or 0,
                                       fast_scale=fast_scale)
        out = np.zeros((len(blobs), base_size, base_size, 3), np.uint8)
        ok = np.zeros(len(blobs), bool)
        jpeg_idx = [i for i, j in enumerate(is_jpeg) if j]
        if jpeg_idx:
            sub, sub_ok = native.decode_batch(
                [blobs[i] for i in jpeg_idx], resize_to, base_size,
                num_threads=num_threads or 0, fast_scale=fast_scale,
            )
            out[jpeg_idx], ok[jpeg_idx] = sub, sub_ok
        other_idx = [i for i, j in enumerate(is_jpeg) if not j]
        sub, sub_ok = decode_batch(
            [blobs[i] for i in other_idx], resize_to, base_size,
            num_threads, backend="pil", fast_scale=fast_scale,
        )
        out[other_idx], ok[other_idx] = sub, sub_ok
        return out, ok
    if backend != "pil":
        raise ValueError(f"unknown decode backend {backend!r}; have "
                         "'auto', 'turbo', 'pil'")

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


def decode_pil_tencrop(data: bytes, resize_to=DEFAULT_RESIZE, crop=224):
    """bytes -> (10, crop, crop, 3) uint8 with torchvision-exact geometry.

    Resize the shorter side to `resize_to`, then TenCrop on the full
    resized rectangle (4 corners + center, plus their horizontal flips) --
    the reference eval transform. The default device path crops a center
    square first (static shapes); this host path is for parity evaluation
    of imported reference checkpoints on non-square images.
    """
    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGB")
    w, h = img.size
    # torchvision Resize(int): shorter side -> resize_to, longer side
    # floor-scaled (int(size * long / short)), not rounded.
    if w <= h:
        nw, nh = resize_to, int(resize_to * h / w)
    else:
        nw, nh = int(resize_to * w / h), resize_to
    img = img.resize((nw, nh), Image.BILINEAR)
    arr = np.asarray(img, dtype=np.uint8)
    cc_top, cc_left = (nh - crop) // 2, (nw - crop) // 2
    offsets = [
        (0, 0), (0, nw - crop), (nh - crop, 0), (nh - crop, nw - crop),
        (cc_top, cc_left),
    ]
    crops = [arr[t:t + crop, l:l + crop] for t, l in offsets]
    crops += [c[:, ::-1] for c in crops]
    return np.stack(crops)


def decode_batch_tencrop(blobs, resize_to=DEFAULT_RESIZE, crop=224,
                         num_threads: Optional[int] = None):
    """Decode + exact ten-crop many blobs -> ((N, 10, crop, crop, 3), ok)."""
    n = len(blobs)
    out = np.zeros((n, 10, crop, crop, 3), dtype=np.uint8)
    ok = np.zeros(n, dtype=bool)

    def work(i):
        try:
            out[i] = decode_pil_tencrop(blobs[i], resize_to, crop)
            ok[i] = True
        except Exception:  # noqa: BLE001 - any undecodable blob is flagged
            pass

    workers = num_threads or min(16, (os.cpu_count() or 1) * 2)
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

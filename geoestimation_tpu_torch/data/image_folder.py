"""Image-folder eval dataset: the reference's inference/test input format.

The port of `geoestimation_tpu/data/image_folder.py`. Reference behavior (README.md:110): `--image_dir`
globs `*.jpg, *.jpeg, *.png`; meta CSVs carry required columns IMG_ID, LAT,
LON (README.md:156). Batches are padded to a fixed size with a validity mask,
so every batch has one shape. pandas is imported where a meta CSV is read.
"""

from __future__ import annotations

import glob
import os
import threading
import queue
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

from ..ingest import decode

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png")


def list_images(image_dir: str) -> list:
    paths = []
    for ext in IMAGE_EXTENSIONS:
        paths.extend(glob.glob(os.path.join(image_dir, f"*{ext}")))
        paths.extend(glob.glob(os.path.join(image_dir, f"*{ext.upper()}")))
    return sorted(set(paths))


@dataclass
class EvalBatch:
    ids: list            # image ids (file names), padded entries repeat last
    images: np.ndarray   # (B, base, base, 3) or (B, 10, crop, crop, 3) uint8
    valid: np.ndarray    # (B,) bool — False for padding or decode failures


def iter_image_folder(
    image_dir: str,
    batch_size: int = 64,
    base_size: int = 256,
    resize_to: int = 256,
    num_workers: Optional[int] = None,
    prefetch: int = 2,
    tencrop_host: bool = False,
    crop: int = 224,
    fast_decode: bool = False,
    process_slice=None,
) -> Iterator[EvalBatch]:
    """Decode-and-batch iterator with background prefetch.

    The decode of batch k+1 overlaps the device compute of batch k: batches
    are produced by a worker thread into a bounded queue.

    tencrop_host=True yields torchvision-exact host ten-crops
    (B, 10, crop, crop, 3) instead of (B, base, base, 3) squares -- the
    strict-parity path for imported reference checkpoints.

    fast_decode=True enables scaled DCT decode for JPEGs (several times
    faster host ingest on large photos, slightly different pixel values —
    see ingest.decode.decode_pil); off by default for parity.

    process_slice=(p, n): multi-process eval (parallel/multihost.py) --
    this process keeps sorted(files)[p::n]. An empty slice (a folder
    smaller than the group) yields zero batches rather than raising: the
    global set is non-empty and the count merge handles idle processes.
    """
    paths = list_images(image_dir)
    if not paths:
        raise FileNotFoundError(
            f"no {'/'.join(IMAGE_EXTENSIONS)} images in {image_dir!r}"
        )
    if process_slice is not None:
        p, n = process_slice
        paths = paths[p::n]

    def produce(q, stop):
        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            for start in range(0, len(paths), batch_size):
                chunk = paths[start:start + batch_size]
                blobs = decode.read_files(chunk)
                if tencrop_host:
                    images, ok = decode.decode_batch_tencrop(
                        blobs, resize_to=resize_to, crop=crop,
                        num_threads=num_workers,
                    )
                else:
                    images, ok = decode.decode_batch(
                        blobs, resize_to=resize_to, base_size=base_size,
                        num_threads=num_workers, fast_scale=fast_decode,
                    )
                ids = [os.path.basename(p) for p in chunk]
                pad = batch_size - len(chunk)
                if pad:
                    images = np.concatenate(
                        [images, np.zeros((pad,) + images.shape[1:],
                                          np.uint8)]
                    )
                    ok = np.concatenate([ok, np.zeros(pad, bool)])
                    ids = ids + [ids[-1]] * pad
                if not put(EvalBatch(ids=ids, images=images, valid=ok)):
                    return
            put(None)
        except BaseException as e:  # noqa: BLE001 - re-raised in consumer
            put(e)

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    t = threading.Thread(target=produce, args=(q, stop), daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def load_meta_csv(path: str):
    """Ground-truth CSV with required columns IMG_ID, LAT, LON
    (reference README.md:156). Column names matched case-insensitively.
    Returns a pandas DataFrame."""
    import pandas as pd

    df = pd.read_csv(path)
    cols = {c.lower(): c for c in df.columns}
    missing = [k for k in ("img_id", "lat", "lon") if k not in cols]
    if missing:
        raise ValueError(
            f"meta file {path!r} missing required columns "
            f"{[m.upper() for m in missing]} (README.md:156); has "
            f"{list(df.columns)}"
        )
    out = df.rename(columns={cols["img_id"]: "IMG_ID", cols["lat"]: "LAT",
                             cols["lon"]: "LON"})
    out["IMG_ID"] = out["IMG_ID"].astype(str)
    return out[["IMG_ID", "LAT", "LON"]]

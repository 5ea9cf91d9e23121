"""Training/validation batch loader: shards -> decoded uint8 batches.

The port of `geoestimation_tpu/data/loader.py`:

  msgpack shards (host) -> decode threads (native or PIL, host) ->
  bounded prefetch queue -> uint8 (B, base, base, 3) + int32 labels ->
  device (augmentation and normalization run on the device, in the step)

Labels come either from a label CSV (IMG_ID -> one class per partitioning,
the output of `assign_classes`) or directly from per-record lat/lng via the
partitionings. Unlabelable records are dropped. pandas is imported where a
label CSV is read.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

from ..geo import assign_classes
from ..ingest import decode
from . import shards


@dataclass
class TrainBatch:
    images: np.ndarray    # (B, base, base, 3) uint8
    labels: np.ndarray    # (P, B) int32, -1 = invalid
    ids: Optional[list] = None
    latlng: Optional[np.ndarray] = None  # (B, 2) float32 when known
    scene: Optional[np.ndarray] = None   # (B,) int32, -1 = unknown (ISN)


SCENE_COLUMN_ALIASES = ("scene", "s3", "s3_label", "scene_label")


def load_label_csv(path: str, shortnames: Sequence[str],
                   with_scene: bool = False):
    """Label CSV: IMG_ID plus one column per partitioning shortname (the
    `assign_classes` output format), optionally a scene column (Places365
    S3 concept: 0=indoor 1=natural 2=urban — the mp16_places365.csv extra
    columns, reference README.md:209-210).

    Returns {img_id: (P,) int32}, or (labels, scene_map) when with_scene.
    """
    import pandas as pd

    df = pd.read_csv(path)
    cols = {c.lower(): c for c in df.columns}
    if "img_id" not in cols:
        raise ValueError(f"label CSV {path!r} needs an IMG_ID column")
    label_cols = []
    for name in shortnames:
        if name.lower() not in cols:
            raise ValueError(
                f"label CSV {path!r} missing column {name!r} "
                f"(one per partitioning shortname)"
            )
        label_cols.append(cols[name.lower()])
    ids = df[cols["img_id"]].astype(str).values
    labels = df[label_cols].to_numpy(dtype=np.int32)
    label_map = dict(zip(ids, map(tuple, labels)))
    if not with_scene:
        return label_map
    scene_map = None
    for alias in SCENE_COLUMN_ALIASES:
        if alias in cols:
            scene_map = dict(
                zip(ids, df[cols[alias]].to_numpy(dtype=np.int32))
            )
            break
    return label_map, scene_map


class ShardBatcher:
    """Background-threaded shard reader + decoder producing TrainBatch."""

    def __init__(
        self,
        shard_patterns: Sequence[str],
        batch_size: int,
        partitionings=None,
        label_map: Optional[dict] = None,
        base_size: int = 256,
        resize_to: int = 256,
        shuffle: bool = True,
        seed: int = 0,
        repeat: bool = True,
        num_workers: Optional[int] = None,
        prefetch: int = 4,
        drop_unlabeled: bool = True,
        scene_map: Optional[dict] = None,
        host_id: int = 0,
        host_count: int = 1,
        shuffle_mode: str = "buffer",
        mask_padding: bool = False,
    ):
        """shuffle_mode: 'buffer' streams shards with a shuffle buffer
        (constant memory); 'global' builds a byte-offset index and visits
        records in an exact per-epoch permutation (random IO).
        mask_padding: tile-padded duplicate entries get labels -1 and NaN
        coordinates so evaluation doesn't double-count them (set for
        validation; training keeps duplicates labeled to fill the batch).
        host_id/host_count: this process's strided share of the records
        (one process reads them all)."""
        if partitionings is None and label_map is None:
            raise ValueError("need partitionings or label_map for labels")
        self.patterns = list(shard_patterns)
        self.batch_size = batch_size
        self.partitionings = partitionings
        self.label_map = label_map
        self.base_size = base_size
        self.resize_to = resize_to
        self.shuffle = shuffle
        self.seed = seed
        self.repeat = repeat
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_unlabeled = drop_unlabeled
        self.scene_map = scene_map
        self.host_id = host_id
        self.host_count = host_count
        if shuffle_mode not in ("buffer", "global"):
            raise ValueError(f"unknown shuffle_mode {shuffle_mode!r}")
        self.shuffle_mode = shuffle_mode
        self.mask_padding = mask_padding
        self.n_partitionings = (
            len(partitionings) if partitionings is not None
            else len(next(iter(label_map.values())))
        )

    def _labels_for(self, recs):
        p = self.n_partitionings
        labels = np.full((p, len(recs)), -1, dtype=np.int32)
        latlng = np.full((len(recs), 2), np.nan, dtype=np.float32)
        if self.label_map is not None:
            for i, r in enumerate(recs):
                got = self.label_map.get(str(r.get("id")))
                if got is not None:
                    labels[:, i] = got
                if "lat" in r:
                    latlng[i] = (r["lat"], r["lng"])
        else:
            has = [i for i, r in enumerate(recs) if "lat" in r]
            if has:
                lat = np.array([recs[i]["lat"] for i in has])
                lng = np.array([recs[i]["lng"] for i in has])
                lab = assign_classes(lat, lng, self.partitionings)
                labels[:, has] = lab
                latlng[has, 0] = lat
                latlng[has, 1] = lng
        return labels, latlng

    def _iter_source(self):
        if self.shuffle and self.shuffle_mode == "global":
            import random

            source = shards.MsgpackDataSource(self.patterns)
            # host-sharded strided subset of the global index
            indices = list(range(self.host_id, len(source),
                                 self.host_count))
            rng = random.Random(self.seed)
            epoch = 0
            while True:
                rng.shuffle(indices)
                for i in indices:
                    yield source[i]
                epoch += 1
                if not self.repeat:
                    source.close()
                    return
        else:
            yield from shards.iter_records(
                self.patterns, shuffle=self.shuffle, seed=self.seed,
                repeat=self.repeat, host_id=self.host_id,
                host_count=self.host_count,
            )

    def _produce(self, q, stop):
        # Errors must reach the consumer: a swallowed exception here would
        # look like a clean end-of-data and silently truncate the dataset.
        # The stop event lets an abandoned iterator unblock us (a plain
        # q.put would park this thread — and its shard file handles —
        # forever once the consumer walks away).
        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            pending = []
            for rec in self._iter_source():
                pending.append(rec)
                if len(pending) < self.batch_size:
                    continue
                batch = self._make_batch(pending)
                pending = []
                if batch is not None and not put(batch):
                    return
            if pending:
                batch = self._make_batch(pending, pad_to=self.batch_size)
                if batch is not None and not put(batch):
                    return
            put(None)
        except BaseException as e:  # noqa: BLE001 - re-raised in consumer
            put(e)

    def _make_batch(self, recs, pad_to=None):
        images, ok = decode.decode_batch(
            [r["image"] for r in recs],
            resize_to=self.resize_to,
            base_size=self.base_size,
            num_threads=self.num_workers,
        )
        labels, latlng = self._labels_for(recs)
        labels[:, ~ok] = -1
        scene = np.full(len(recs), -1, dtype=np.int32)
        if self.scene_map is not None:
            for i, r in enumerate(recs):
                scene[i] = self.scene_map.get(str(r.get("id")), -1)
        if self.drop_unlabeled:
            keep = ok & (labels >= 0).all(axis=0)
            if not keep.any():
                return None
            images, labels, latlng, scene = (
                images[keep], labels[:, keep], latlng[keep], scene[keep]
            )
            recs = [r for r, k in zip(recs, keep) if k]
        n = images.shape[0]
        size = pad_to or self.batch_size
        if n < size:
            reps = -(-size // n)
            idx = np.tile(np.arange(n), reps)[:size]
        elif n > size:
            idx = np.arange(size)
        else:
            idx = None
        if idx is not None:
            images, labels, latlng, scene = (
                images[idx], labels[:, idx], latlng[idx], scene[idx]
            )
            recs = [recs[i] for i in idx]
            if self.mask_padding and n < size:
                labels[:, n:] = -1
                latlng[n:] = np.nan
                scene[n:] = -1
        return TrainBatch(
            images=images, labels=labels,
            ids=[str(r.get("id")) for r in recs], latlng=latlng,
            scene=scene,
        )

    def __iter__(self) -> Iterator[TrainBatch]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=self._produce, args=(q, stop),
                             daemon=True)
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

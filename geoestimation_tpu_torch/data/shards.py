"""MessagePack training shards, in the JAX package's format.

The port of `geoestimation_tpu/data/shards.py`, byte for byte the same
files: each shard is a stream of msgpack-encoded records, a record a map
with (at least) an id and the raw JPEG bytes. It writes
`{"id": str, "image": bytes, "lat": float, "lng": float}` and reads
tolerantly (historical readers used keys like `_id`/`image`), so shards made
by the original tooling stay loadable.

Reading streams: shard order and an in-stream shuffle buffer give the
training-time randomness without an index; `build_index` gives byte offsets
for random access and an exact global shuffle.
"""

from __future__ import annotations

import glob
import os
import random
from typing import Iterable, Iterator, Optional, Sequence

import msgpack

ID_KEYS = ("id", "_id", "img_id", "image_id")
IMAGE_KEYS = ("image", "img", "jpeg", "data")
LAT_KEYS = ("lat", "latitude")
LNG_KEYS = ("lng", "lon", "longitude")


def _first(record: dict, keys):
    for k in keys:
        if k in record:
            return record[k]
        kb = k.encode() if isinstance(k, str) else k
        if kb in record:
            return record[kb]
    return None


def normalize_record(raw: dict) -> Optional[dict]:
    """Map a raw msgpack record to {id, image, lat?, lng?}; None if it has
    no image payload."""
    image = _first(raw, IMAGE_KEYS)
    if image is None:
        return None
    rid = _first(raw, ID_KEYS)
    if isinstance(rid, bytes):
        rid = rid.decode("utf-8", "replace")
    out = {"id": rid, "image": image}
    lat = _first(raw, LAT_KEYS)
    lng = _first(raw, LNG_KEYS)
    if lat is not None and lng is not None:
        out["lat"] = float(lat)
        out["lng"] = float(lng)
    return out


def write_shard(records: Iterable[dict], path: str):
    """Write records ({'id', 'image', optional 'lat'/'lng'}) to one shard."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    packer = msgpack.Packer(use_bin_type=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for r in records:
            f.write(packer.pack(r))
    os.replace(tmp, path)


def iter_shard(path: str) -> Iterator[dict]:
    with open(path, "rb") as f:
        unpacker = msgpack.Unpacker(f, raw=True, max_buffer_size=0)
        for raw in unpacker:
            rec = normalize_record(raw)
            if rec is not None:
                yield rec


def expand_shard_patterns(patterns: Sequence[str]) -> list:
    paths = []
    for pat in patterns:
        hits = sorted(glob.glob(pat))
        paths.extend(hits if hits else ([pat] if os.path.exists(pat) else []))
    return paths


def iter_records(
    patterns: Sequence[str],
    shuffle: bool = False,
    seed: int = 0,
    shuffle_buffer: int = 2048,
    repeat: bool = False,
    host_id: int = 0,
    host_count: int = 1,
) -> Iterator[dict]:
    """Stream records across shards; optional shard-order shuffle + in-
    stream reservoir-style shuffle buffer, both drawn from
    `random.Random(seed)`.

    With `host_count > 1`, this host reads the strided subset
    `shards[host_id::host_count]`.
    """
    paths = expand_shard_patterns(patterns)
    if not paths:
        raise FileNotFoundError(f"no shards match {list(patterns)!r}")
    if host_count > 1:
        paths = paths[host_id::host_count]
        if not paths:
            raise ValueError(
                f"host {host_id}/{host_count} got no shards "
                f"({len(expand_shard_patterns(patterns))} total) — need at "
                f"least one shard per host"
            )
    rng = random.Random(seed)
    epoch = 0
    while True:
        order = list(paths)
        if shuffle:
            rng.shuffle(order)
        if shuffle:
            buf = []
            for path in order:
                for rec in iter_shard(path):
                    if len(buf) < shuffle_buffer:
                        buf.append(rec)
                        continue
                    j = rng.randrange(shuffle_buffer)
                    buf[j], rec = rec, buf[j]
                    yield rec
            rng.shuffle(buf)
            yield from buf
        else:
            for path in order:
                yield from iter_shard(path)
        epoch += 1
        if not repeat:
            return


def count_records(patterns: Sequence[str]) -> int:
    return sum(1 for _ in iter_records(patterns))


# ---------------------------------------------------------------------------
# Random access: byte-offset index -> true global shuffle
# ---------------------------------------------------------------------------


def build_index(patterns: Sequence[str]):
    """Byte-offset index over shards: list of (path, offset) per record.

    One sequential pass (msgpack framing is self-delimiting); afterwards
    any record is a seek+unpack away, which gives an exact global shuffle
    instead of the approximate shuffle buffer.
    """
    paths = expand_shard_patterns(patterns)
    if not paths:
        raise FileNotFoundError(f"no shards match {list(patterns)!r}")
    index = []
    for path in paths:
        with open(path, "rb") as f:
            unpacker = msgpack.Unpacker(f, raw=True, max_buffer_size=0)
            offset = 0
            try:
                while True:
                    raw = unpacker.unpack()
                    next_offset = unpacker.tell()
                    if normalize_record(raw) is not None:
                        index.append((path, offset))
                    offset = next_offset
            except msgpack.OutOfData:
                pass
    return index


def read_record_at(path: str, offset: int) -> dict:
    with open(path, "rb") as f:
        f.seek(offset)
        unpacker = msgpack.Unpacker(f, raw=True, max_buffer_size=0)
        return normalize_record(unpacker.unpack())


class MsgpackDataSource:
    """Random-access data source over msgpack shards (__len__ /
    __getitem__): the global-shuffle backend of
    `ShardBatcher(shuffle_mode="global")`. Keeps one open file handle per
    shard (cheap; shards are O(100s)).
    """

    def __init__(self, patterns: Sequence[str]):
        self.index = build_index(patterns)
        self._handles = {}

    def __len__(self):
        return len(self.index)

    def __getitem__(self, i: int) -> dict:
        path, offset = self.index[int(i)]
        f = self._handles.get(path)
        if f is None:
            f = open(path, "rb")
            self._handles[path] = f
        f.seek(offset)
        unpacker = msgpack.Unpacker(f, raw=True, max_buffer_size=0)
        return normalize_record(unpacker.unpack())

    def close(self):
        for f in self._handles.values():
            f.close()
        self._handles.clear()

    # a copy sent to another process drops the open handles (each copy
    # lazily reopens its own).
    def __getstate__(self):
        return {"index": self.index}

    def __setstate__(self, state):
        self.index = state["index"]
        self._handles = {}

"""S2 cell partitionings: the class <-> cell <-> lat/lng mapping.

A copy of `geoestimation_tpu/geo/partitioning.py`. File-format parity with
the reference's `cells_50_*.csv` partitioning files
(reference README.md:250-253): one row per class with the class index, the
S2 cell hex token, the number of training images in the cell, and the mean
lat/lng of those images. Headers are parsed by name, tolerantly, since the
exact historical header spelling is not in the reference snapshot
(SURVEY.md §4 "Key file-format contracts").
"""

from __future__ import annotations

import csv
import os
import re
from dataclasses import dataclass, field

import numpy as np

from . import s2

# Canonical header names we write; aliases we accept when reading.
_COL_ALIASES = {
    "class_label": {"class_label", "class_indexes", "class_index", "class", "label"},
    "hex_id": {"hex_id", "hexid", "token", "cell_token", "s2_token", "cell_id"},
    "imgs_per_cell": {"imgs_per_cell", "images_per_cell", "count", "num_images", "imgs"},
    "latitude_mean": {"latitude_mean", "mean_lat", "lat_mean", "latitude", "lat"},
    "longitude_mean": {"longitude_mean", "mean_lng", "lng_mean", "longitude", "lng", "lon"},
}


def _resolve_columns(header):
    lower = [h.strip().lower() for h in header]
    mapping = {}
    for canon, aliases in _COL_ALIASES.items():
        for idx, name in enumerate(lower):
            if name in aliases:
                mapping[canon] = idx
                break
    missing = {"class_label", "hex_id", "latitude_mean", "longitude_mean"} - set(mapping)
    if missing:
        raise ValueError(
            f"partitioning CSV missing required columns {sorted(missing)}; "
            f"got header {header}"
        )
    return mapping


@dataclass
class Partitioning:
    """One S2 cell partitioning loaded from a cell CSV.

    Attributes:
      name: short name (e.g. "coarse", "middle", "fine"), defaults to a name
        derived from the file name (reference configs name them by shortname).
      cell_ids: (C,) uint64 S2 cell ids, indexed by class.
      tokens: (C,) str hex tokens, indexed by class.
      counts: (C,) int64 images per cell (0 if absent in the file).
      lat, lng: (C,) float32 mean coordinates per class — the values emitted
        as predictions (reference README.md:118-124 output contract).
      levels: (C,) int8 S2 level per class cell.
    """

    name: str
    tokens: np.ndarray
    lat: np.ndarray
    lng: np.ndarray
    counts: np.ndarray
    cell_ids: np.ndarray = field(default=None)
    levels: np.ndarray = field(default=None)
    _token_to_class: dict = field(default=None, repr=False)
    _id_to_class: dict = field(default=None, repr=False)

    def __post_init__(self):
        if self.cell_ids is None:
            self.cell_ids = s2.token_to_id(self.tokens)
        if self.levels is None:
            self.levels = s2.cell_level(self.cell_ids).astype(np.int8)
        if self._token_to_class is None:
            self._token_to_class = {t: i for i, t in enumerate(self.tokens.tolist())}
        if self._id_to_class is None:
            self._id_to_class = {
                int(c): i for i, c in enumerate(self.cell_ids.tolist())
            }

    def __len__(self):
        return len(self.tokens)

    @property
    def n_classes(self):
        return len(self.tokens)

    @classmethod
    def from_csv(cls, path, name=None):
        if name is None:
            name = shortname_from_filename(path)
        with open(path, newline="") as f:
            reader = csv.reader(f)
            rows = [r for r in reader if r and any(c.strip() for c in r)]
        cols = _resolve_columns(rows[0])
        body = rows[1:]
        labels = [int(float(r[cols["class_label"]])) for r in body]
        if sorted(labels) != list(range(len(body))):
            raise ValueError(
                f"partitioning CSV {path!r}: class_label column must be a "
                f"permutation of 0..{len(body) - 1} (got min "
                f"{min(labels, default=0)}, max {max(labels, default=0)}, "
                f"{len(set(labels))} unique of {len(body)} rows) — a "
                f"filtered/reindexed file would silently shift classes"
            )
        order = np.argsort(labels)
        body = [body[i] for i in order]
        tokens = np.array([r[cols["hex_id"]].strip().lower() for r in body])
        lat = np.array([float(r[cols["latitude_mean"]]) for r in body], np.float64)
        lng = np.array([float(r[cols["longitude_mean"]]) for r in body], np.float64)
        if "imgs_per_cell" in cols:
            counts = np.array(
                [int(float(r[cols["imgs_per_cell"]])) for r in body], np.int64
            )
        else:
            counts = np.zeros(len(body), np.int64)
        return cls(name=name, tokens=tokens, lat=lat, lng=lng, counts=counts)

    def to_csv(self, path):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(
                ["class_label", "hex_id", "imgs_per_cell",
                 "latitude_mean", "longitude_mean"]
            )
            for i in range(len(self)):
                w.writerow(
                    [i, self.tokens[i], int(self.counts[i]),
                     repr(float(self.lat[i])), repr(float(self.lng[i]))]
                )

    # -- lookups ------------------------------------------------------------

    def class_of_token(self, token):
        return self._token_to_class.get(str(token).lower(), -1)

    def class_of_id(self, cell_id):
        return self._id_to_class.get(int(cell_id), -1)

    def get_lat_lng(self, class_index):
        return float(self.lat[class_index]), float(self.lng[class_index])

    @property
    def max_level(self):
        return int(self.levels.max())

    @property
    def min_level(self):
        return int(self.levels.min())

    def contains_ancestor_classes(self, leaf_ids):
        """Vectorized: for leaf cell ids, the class of the deepest cell in
        this partitioning containing each point, or -1. (N,) int32."""
        leaf_ids = np.asarray(leaf_ids, dtype=np.uint64)
        out = np.full(leaf_ids.shape, -1, dtype=np.int32)
        order = np.argsort(self.cell_ids)
        sorted_ids = self.cell_ids[order]
        sorted_cls = np.arange(len(self), dtype=np.int32)[order]
        # Walk levels deepest-first so the first (deepest) hit wins; match
        # ancestors against the sorted cell-id table with searchsorted.
        for level in range(self.max_level, self.min_level - 1, -1):
            unresolved = out < 0
            if not np.any(unresolved):
                break
            anc = s2.parent_at_level(leaf_ids[unresolved], level)
            pos = np.searchsorted(sorted_ids, anc)
            pos_c = np.minimum(pos, len(sorted_ids) - 1)
            hit = sorted_ids[pos_c] == anc
            tmp = out[unresolved]
            tmp[hit] = sorted_cls[pos_c[hit]]
            out[unresolved] = tmp
        return out


def assign_classes(lat, lng, partitionings):
    """Per-image class labels for each partitioning: each image's leaf S2
    cell, looked up in every partitioning. (P, N) int32, -1 where the image
    falls outside all cells of a partitioning."""
    leaf = s2.latlng_to_cell_id(np.asarray(lat, np.float64),
                                np.asarray(lng, np.float64))
    return np.stack(
        [p.contains_ancestor_classes(leaf) for p in partitionings], axis=0
    )


def shortname_from_filename(path):
    """Map a cells_<min>_<max>.csv filename to the reference's shortnames:
    5000->coarse, 2000->middle, 1000->fine (reference README.md:250-253);
    otherwise the file stem."""
    stem = os.path.splitext(os.path.basename(path))[0]
    m = re.match(r"cells_(\d+)_(\d+)", stem)
    if m:
        return {"5000": "coarse", "2000": "middle", "1000": "fine"}.get(
            m.group(2), stem
        )
    return stem


def load_partitionings(paths, names=None):
    """Load several partitionings ordered coarse -> fine (by class count)."""
    parts = [
        Partitioning.from_csv(p, name=(names[i] if names else None))
        for i, p in enumerate(paths)
    ]
    return parts

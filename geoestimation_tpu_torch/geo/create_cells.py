"""Adaptive S2 cell partitioning builder.

The port of `geoestimation_tpu/geo/create_cells.py` (numpy only): starting
from level `lvl_min` (default 2), split every cell holding more than
`img_max` images into its 4 children until no cell is overfull or `lvl_max`
(default 30) is reached, then drop cells with fewer than `img_min` images.

Vectorized over all images: each refinement round recomputes the ancestors
of the (precomputed, level-30) leaf ids for just the images living in
overfull cells -- O(rounds * N) numpy work, which partitions millions of
points in seconds. The leaf ids come from the C++ library for large inputs
where it builds (`native.py`); the ids, and so the cells, are the same
either way.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import s2
from .partitioning import Partitioning


@dataclass
class CreateCellsResult:
    partitioning: Partitioning
    n_images_total: int
    n_images_kept: int
    n_rounds: int


def create_cells(
    lat,
    lng,
    img_min=50,
    img_max=1000,
    lvl_min=2,
    lvl_max=30,
    name=None,
    verbose=False,
):
    """Build an adaptive partitioning from per-image coordinates.

    Args:
      lat, lng: (N,) coordinate arrays in degrees.
      img_min: drop cells with fewer images than this (README.md:232).
      img_max: split cells with more images than this (README.md:233).
      lvl_min: starting S2 level (README.md:234, default 2).
      lvl_max: maximum split depth (README.md:235, default 30).
      verbose: per-split-round progress on stdout (the reference CLI's
        `-v/--verbose`, README.md:228-229).

    Returns a `CreateCellsResult` whose partitioning's classes are sorted by
    cell id (deterministic class indexing).
    """
    lat = np.asarray(lat, dtype=np.float64)
    lng = np.asarray(lng, dtype=np.float64)
    n = lat.shape[0]
    leaf = s2.latlng_to_cell_id(lat, lng)
    levels = np.full(n, lvl_min, dtype=np.int64)
    cells = s2.parent_at_level(leaf, lvl_min)

    rounds = 0
    while True:
        uniq, inv, counts = np.unique(cells, return_inverse=True,
                                      return_counts=True)
        overfull_cell = counts > img_max
        img_overfull = overfull_cell[inv] & (levels < lvl_max)
        if verbose:
            print(f"round {rounds}: {len(uniq)} cells, "
                  f"{int(overfull_cell.sum())} over img_max={img_max}, "
                  f"splitting {int(img_overfull.sum())} images "
                  f"(max level {int(levels.max())})", flush=True)
        if not np.any(img_overfull):
            break
        levels = np.where(img_overfull, levels + 1, levels)
        cells[img_overfull] = s2.parent_at_level(
            leaf[img_overfull], levels[img_overfull]
        )
        rounds += 1

    uniq, inv, counts = np.unique(cells, return_inverse=True, return_counts=True)
    keep = counts >= img_min
    kept_cells = uniq[keep]
    # Remap images to kept cells; compute per-cell coordinate means.
    kept_index = np.full(len(uniq), -1, dtype=np.int64)
    kept_index[keep] = np.arange(keep.sum())
    img_cls = kept_index[inv]
    in_keep = img_cls >= 0
    c = int(keep.sum())
    sum_lat = np.bincount(img_cls[in_keep], weights=lat[in_keep], minlength=c)
    sum_lng = np.bincount(img_cls[in_keep], weights=lng[in_keep], minlength=c)
    cnt = np.bincount(img_cls[in_keep], minlength=c).astype(np.int64)

    part = Partitioning(
        name=name or f"cells_{img_min}_{img_max}",
        tokens=np.asarray(s2.id_to_token(kept_cells)),
        lat=sum_lat / np.maximum(cnt, 1),
        lng=sum_lng / np.maximum(cnt, 1),
        counts=cnt,
        cell_ids=kept_cells,
    )
    return CreateCellsResult(
        partitioning=part,
        n_images_total=n,
        n_images_kept=int(in_keep.sum()),
        n_rounds=rounds,
    )


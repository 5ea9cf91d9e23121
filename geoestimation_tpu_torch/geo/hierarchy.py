"""Cross-partitioning ancestor maps for the hierarchical f* rule.

A copy of `geoestimation_tpu/geo/hierarchy.py`. The reference's
`classification/s2_utils.py` `Hierarchy` class precomputed,
for every fine cell, the index of its ancestor cell in each coarser
partitioning (SURVEY.md §3.1). Here the maps are materialized host-side as
int32 gather tables and shipped to the device once; the f* rule then becomes
pure gathers + sums on the device (see `eval/infer.py`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import s2
from .partitioning import Partitioning


def ancestor_map(fine: Partitioning, coarse: Partitioning):
    """For every class in `fine`, the class index of its deepest ancestor
    (or equal) cell in `coarse`; -1 when no ancestor exists.

    Walks each fine cell's S2 parent chain from its own level up to level 0
    and takes the first token present in `coarse` — i.e. the deepest
    containing cell (SURVEY.md §8 "Hierarchy semantics").
    """
    out = np.full(len(fine), -1, dtype=np.int32)
    fine_ids = fine.cell_ids
    fine_levels = s2.cell_level(fine_ids)
    for i in range(len(fine)):
        cid = fine_ids[i]
        for level in range(int(fine_levels[i]), -1, -1):
            anc = s2.parent_at_level(cid, level)
            cls = coarse.class_of_id(int(anc))
            if cls >= 0:
                out[i] = cls
                break
    return out


@dataclass
class Hierarchy:
    """Ancestor gather maps over an ordered [coarse, ..., fine] stack.

    `maps[k]` has shape (n_fine_classes,) and maps a fine class index to its
    ancestor class in partitionings[k]; `maps[-1]` is the identity. `valid`
    masks fine classes that have ancestors in every coarser partitioning
    (in practice all of them when the partitionings come from one dataset).
    """

    partitionings: list
    maps: list
    valid: np.ndarray

    @classmethod
    def build(cls, partitionings):
        if len(partitionings) < 1:
            raise ValueError("need at least one partitioning")
        fine = partitionings[-1]
        maps = [ancestor_map(fine, p) for p in partitionings[:-1]]
        maps.append(np.arange(len(fine), dtype=np.int32))
        valid = np.ones(len(fine), dtype=bool)
        for m in maps[:-1]:
            valid &= m >= 0
        # Clamp missing ancestors to class 0 so gathers stay in-bounds; the
        # `valid` mask zeroes those fine cells out of the f* product.
        maps = [np.where(m < 0, 0, m).astype(np.int32) for m in maps]
        return cls(partitionings=list(partitionings), maps=maps, valid=valid)

    @property
    def n_fine(self):
        return len(self.partitionings[-1])

"""Geo core: S2 cell math, partitionings, hierarchy (numpy only)."""

from . import s2
from .hierarchy import Hierarchy, ancestor_map
from .partitioning import Partitioning, assign_classes, load_partitionings

__all__ = ["s2", "Hierarchy", "ancestor_map", "Partitioning",
           "assign_classes", "load_partitionings"]

"""Geo core: S2 cell math, partitionings, hierarchy (numpy only)."""

from . import s2
from .create_cells import CreateCellsResult, create_cells
from .hierarchy import Hierarchy, ancestor_map
from .partitioning import Partitioning, assign_classes, load_partitionings

__all__ = ["s2", "create_cells", "CreateCellsResult", "assign_classes",
           "Hierarchy", "ancestor_map", "Partitioning", "load_partitionings"]

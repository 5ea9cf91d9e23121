"""The port's partitioning CLIs: `create_cells` and `assign_classes`."""

"""Multi-process runtime (`multihost`) and the data-parallel layout
(`mesh`), on torch.distributed."""

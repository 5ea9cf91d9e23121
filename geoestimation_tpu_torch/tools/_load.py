"""A checkpoint with its partitionings, as the QAT and study tools load it."""

from __future__ import annotations

import os


def load_with_partitionings(checkpoint, hparams=None):
    """(config, state_dict, partitionings, n_classes) of a port checkpoint
    directory; the partitioning CSVs resolved against the checkpoint's
    parent, the checkpoint and the working directory, as the JAX tools do."""
    from ..checkpoint import load_checkpoint
    from ..eval.engine import resolve_partitioning_paths
    from ..geo import load_partitionings

    config, state_dict = load_checkpoint(checkpoint, hparams_path=hparams)
    mp = config.model_params
    paths = resolve_partitioning_paths(
        mp.partitionings.files,
        [os.path.dirname(os.path.abspath(checkpoint)), checkpoint,
         os.getcwd()])
    parts = load_partitionings(paths, names=list(mp.partitionings.shortnames))
    return config, state_dict, parts, tuple(len(p) for p in parts)

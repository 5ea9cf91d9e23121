"""The model a config describes: the port of `model_from_config` in
`geoestimation_tpu/train/init.py`."""

from __future__ import annotations

from typing import Sequence

import torch

from ..models.classifier import MultiPartitioningClassifier
from ..models.isn import ISNClassifier

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_from_config(config, n_classes: Sequence[int], dtype=None):
    """`ISNClassifier` for a scene-gated config, else
    `MultiPartitioningClassifier`, with `n_classes` per partitioning; the
    compute dtype is `dtype`, or the config's when None."""
    mp = config.model_params
    dtype = DTYPES[mp.dtype] if dtype is None else dtype
    if mp.scene_gating:
        return ISNClassifier(n_classes, n_scenes=mp.n_scenes, arch=mp.arch,
                             dtype=dtype)
    return MultiPartitioningClassifier(n_classes, mp.arch, dtype)

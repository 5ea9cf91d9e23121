"""Weights bridge: the JAX package's variables -> the port's state dict.

`from_jax_variables` takes the `{"params", "batch_stats"}` trees of a
`geoestimation_tpu` checkpoint as numpy arrays and returns the state dict of
`models.classifier.MultiPartitioningClassifier` (or, for an ISN checkpoint,
`models.isn.ISNClassifier`), under torchvision's keys (the keys
`tools/import_torch_checkpoint.py` reads, behind a `backbone.` prefix):
conv kernels HWIO -> OIHW, BatchNorm scale/bias/mean/var -> weight/bias/
running_mean/running_var, and each Linear head (the fused head, or ISN's
`scene_head` and `scene_geo_heads`) kept as one Linear with its kernel
transposed. The inverse of that tool's `convert_backbone` and `find_heads`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .models.resnet import STAGE_SIZES


def _tensor(a):
    return torch.tensor(np.asarray(a, np.float32))


def from_jax_variables(params, batch_stats, arch: str,
                       n_classes: Sequence[int]) -> dict:
    """numpy trees -> {key: float32 CPU tensor} for the port's model."""
    if arch not in STAGE_SIZES:
        raise ValueError(f"unknown arch {arch!r}; have {sorted(STAGE_SIZES)}")
    sd = {}
    bb_p, bb_s = params["backbone"], batch_stats["backbone"]

    def conv(dst, p):
        sd[f"{dst}.weight"] = _tensor(np.transpose(p["kernel"], (3, 2, 0, 1)))

    def bn(dst, p, s):
        sd[f"{dst}.weight"] = _tensor(p["scale"])
        sd[f"{dst}.bias"] = _tensor(p["bias"])
        sd[f"{dst}.running_mean"] = _tensor(s["mean"])
        sd[f"{dst}.running_var"] = _tensor(s["var"])
        sd[f"{dst}.num_batches_tracked"] = torch.tensor(0)

    def linear(dst, p, n_out):
        kernel = np.asarray(p["kernel"], np.float32)
        if kernel.shape[1] != n_out:
            raise ValueError(f"{dst} has {kernel.shape[1]} outputs; the "
                             f"partitionings need {n_out}")
        sd[f"{dst}.weight"] = _tensor(kernel.T)
        sd[f"{dst}.bias"] = _tensor(p["bias"])

    conv("backbone.conv1", bb_p["conv1"])
    bn("backbone.bn1", bb_p["bn1"], bb_s["bn1"])
    for stage, n_blocks in enumerate(STAGE_SIZES[arch]):
        for b in range(n_blocks):
            src = f"layer{stage + 1}_block{b}"
            dst = f"backbone.layer{stage + 1}.{b}"
            p, s = bb_p[src], bb_s[src]
            for i in (1, 2, 3):
                conv(f"{dst}.conv{i}", p[f"conv{i}"])
                bn(f"{dst}.bn{i}", p[f"bn{i}"], s[f"bn{i}"])
            if "downsample_conv" in p:
                conv(f"{dst}.downsample.0", p["downsample_conv"])
                bn(f"{dst}.downsample.1", p["downsample_bn"],
                   s["downsample_bn"])
    if "scene_head" in params:
        n_scenes = np.shape(params["scene_head"]["kernel"])[1]
        linear("scene_head", params["scene_head"], n_scenes)
        linear("scene_geo_heads", params["scene_geo_heads"],
               n_scenes * sum(n_classes))
    else:
        linear("heads.fused_head", params["heads"]["fused_head"],
               sum(n_classes))
    return sd

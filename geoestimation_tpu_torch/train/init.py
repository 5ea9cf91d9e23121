"""The model a config describes, and its initial weights: the port of
`geoestimation_tpu/train/init.py`."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..models.classifier import MultiPartitioningClassifier
from ..models.isn import ISNClassifier

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# flax's lecun_normal: a normal truncated at two standard deviations, whose
# stddev is divided by that of the unit normal so truncated
TRUNCATED_STD = 0.87962566103423978


def model_from_config(config, n_classes: Sequence[int], dtype=None):
    """`ISNClassifier` for a scene-gated config, else
    `MultiPartitioningClassifier`, with `n_classes` per partitioning; the
    compute dtype is `dtype`, or the config's when None."""
    mp = config.model_params
    dtype = DTYPES[mp.dtype] if dtype is None else dtype
    if mp.scene_gating:
        return ISNClassifier(n_classes, n_scenes=mp.n_scenes, arch=mp.arch,
                             dtype=dtype, remat=mp.remat)
    return MultiPartitioningClassifier(n_classes, mp.arch, dtype,
                                       remat=mp.remat)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int):
    """The JAX model's initializers, drawn from `seed`: every conv and
    Linear weight lecun-normal (variance 1 / fan_in, truncated at two
    standard deviations), biases zero, BatchNorm scale one (zero for each
    block's last, `bn3`) with zero bias, mean 0 and variance 1."""
    gen = torch.Generator().manual_seed(seed)
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            w = torch.empty(m.weight.shape)
            std = (w[0].numel() ** -0.5) / TRUNCATED_STD
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=gen)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(0.0 if name.endswith("bn3") else 1.0)
            m.bias.zero_()
            m.reset_running_stats()
    return model

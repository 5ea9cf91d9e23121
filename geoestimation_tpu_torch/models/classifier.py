"""Multi-partitioning geo classifier: backbone + one head per partitioning.

The port of `geoestimation_tpu/models/classifier.py`: the per-partitioning
heads are one fused Linear over the shared features, computed in float32 and
split by class counts afterwards.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import FEATURE_DIM, build_backbone


class MultiHeadClassifier(nn.Module):
    """Fused classification heads over shared features."""

    def __init__(self, n_classes: Sequence[int], in_features=FEATURE_DIM):
        super().__init__()
        self.n_classes = tuple(n_classes)
        self.fused_head = nn.Linear(in_features, sum(self.n_classes))

    def forward(self, features):
        logits = F.linear(features.float(), self.fused_head.weight,
                          self.fused_head.bias)
        return list(torch.split(logits, self.n_classes, dim=-1))


class MultiPartitioningClassifier(nn.Module):
    """Backbone + per-partitioning heads.

    forward(images NHWC) -> list of per-partitioning float32 logits, ordered
    coarse -> fine (the order of the partitioning files in the config).
    """

    def __init__(self, n_classes: Sequence[int], arch: str = "resnet50",
                 dtype=torch.bfloat16):
        super().__init__()
        self.arch = arch
        self.backbone = build_backbone(arch, dtype=dtype)
        self.heads = MultiHeadClassifier(n_classes)

    def forward(self, images):
        return self.heads(self.backbone(images))

"""ISN -- scene-gated geo heads over one shared backbone.

The port of `geoestimation_tpu/models/isn.py`: one backbone, a scene head
(3 scenes: indoor, natural, urban) and one geo classifier per (scene,
partitioning) pair, held as a single fused Linear of n_scenes * sum(n_classes)
outputs. Both heads compute in float32. Each row is routed to one scene --
its `scene` label when given, else the argmax of its scene logits -- by a
gather of that scene's slice, which selects exactly the row the JAX
package's one-hot einsum selects.

`forward` keeps `MultiPartitioningClassifier`'s contract (a list of (B, C_p)
logits), so the engine and the f* rule work unchanged. `isn_loss` is the
training loss: the scene cross-entropy plus the geo cross-entropies on each
row's ground-truth scene heads.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import multihost
from .classifier import multi_head_cross_entropy
from .resnet import FEATURE_DIM, build_backbone

SCENE_NAMES = ("indoor", "natural", "urban")


def route_rows(per_scene, route):
    """(B, S, C) logits and (B,) scene indices -> (B, C): each row's slice of
    its scene."""
    return per_scene[torch.arange(per_scene.shape[0],
                                  device=per_scene.device), route]


class ISNClassifier(nn.Module):
    """Backbone + scene head + per-scene geo heads, hard-routed by scene."""

    def __init__(self, n_classes: Sequence[int], n_scenes: int = 3,
                 arch: str = "resnet50", dtype=torch.bfloat16, remat=False):
        super().__init__()
        self.n_classes = tuple(n_classes)
        self.n_scenes = n_scenes
        self.arch = arch
        self.backbone = build_backbone(arch, dtype=dtype, remat=remat)
        self.scene_head = nn.Linear(FEATURE_DIM, n_scenes)
        self.scene_geo_heads = nn.Linear(FEATURE_DIM,
                                         n_scenes * sum(self.n_classes))

    def _heads(self, features):
        """(B, F) -> scene logits (B, S) and per-head logits [(B, S, C_p)]."""
        f32 = features.float()
        scene_logits = F.linear(f32, self.scene_head.weight,
                                self.scene_head.bias)
        flat = F.linear(f32, self.scene_geo_heads.weight,
                        self.scene_geo_heads.bias)
        flat = flat.reshape(flat.shape[0], self.n_scenes, -1)
        return scene_logits, list(torch.split(flat, self.n_classes, dim=-1))

    def with_scene(self, images, train=False):
        """(scene_logits, [per-head (B, S, C_p)]) for NHWC images."""
        return self._heads(self.backbone(images, train=train))

    def features(self, images):
        return self.backbone(images)

    def forward(self, images, scene: Optional[torch.Tensor] = None):
        """Routed logits [(B, C_p)]: by `scene` when given, else by the
        argmax of the scene logits."""
        scene_logits, heads = self.with_scene(images)
        route = scene if scene is not None else scene_logits.argmax(-1)
        return [route_rows(h, route) for h in heads]


def isn_loss(scene_logits, head_logits, geo_labels, scene_labels,
             scene_loss_weight: float = 1.0, label_smoothing: float = 0.0):
    """ISN training loss: scene CE + sum of per-partitioning CE on the
    ground-truth-scene head.

    Args:
      scene_logits: (B, S).
      head_logits: list of (B, S, C_p).
      geo_labels: (P, B) int, -1 = ignore.
      scene_labels: (B,) int, -1 = ignore (scene CE masked; geo routed by
        the predicted scene for those rows).
    Returns (total, {"scene_loss", "geo_loss", "per_head"}). In several
    processes each count is the global batch's, as in
    `multi_head_cross_entropy`.
    """
    scene_labels = scene_labels.long()
    s_valid = scene_labels >= 0
    s_safe = scene_labels.clamp(min=0)
    s_logp = F.log_softmax(scene_logits, -1).gather(-1, s_safe[:, None])[:, 0]
    s_nll = torch.where(s_valid, -s_logp, torch.zeros_like(s_logp))
    scene_loss = s_nll.sum() / multihost.device_sum(
        s_valid.sum()).clamp(min=1)
    route = torch.where(s_valid, s_safe, scene_logits.argmax(-1))
    gated = [route_rows(h, route) for h in head_logits]
    geo_loss, per_head = multi_head_cross_entropy(
        gated, geo_labels, label_smoothing=label_smoothing)
    total = geo_loss + scene_loss_weight * scene_loss
    return total, {"scene_loss": scene_loss, "geo_loss": geo_loss,
                   "per_head": per_head}

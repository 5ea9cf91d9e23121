"""Multi-partitioning geo classifier: backbone + one head per partitioning.

The port of `geoestimation_tpu/models/classifier.py`: the per-partitioning
heads are one fused Linear over the shared features, computed in float32 and
split by class counts afterwards; the training loss is the sum of the
heads' cross-entropies (`multi_head_cross_entropy`).

Under a layout with a model axis (`parallel/mesh.py`, n_model > 1) the fused
head keeps only this rank's slice (`MultiHeadClassifier.shard_`), as the JAX
package's mesh places it, and its forward still returns the whole logits on
every rank:

  * classes split (Σ divisible by n_model): the features enter through
    `model_copy` (their gradient summed over the model group), each rank
    computes its classes' logits, and `model_gather` lays the slices side
    by side (the backward hands each rank its slice). Gathering the logits,
    rather than a log-softmax whose max and sum are all-reduced per
    partitioning, keeps the loss the one-process code and its numbers, at
    B x Σ x 4 bytes a step, small beside the head's weight;
  * features split (an odd Σ such as the real 23,393): `model_slice` takes
    this rank's features (the backward gathers their gradient), the partial
    products are summed by `model_sum`, and the replicated bias is added.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import multihost
from .resnet import FEATURE_DIM, build_backbone


class MultiHeadClassifier(nn.Module):
    """Fused classification heads over shared features."""

    def __init__(self, n_classes: Sequence[int], in_features=FEATURE_DIM):
        super().__init__()
        self.n_classes = tuple(n_classes)
        self.fused_head = nn.Linear(in_features, sum(self.n_classes))
        self.split = None           # the layout's dim of the weight, if any

    @torch.no_grad()
    def shard_(self, layout):
        """Keep only this rank's slice of the whole head, by the layout's
        placement (`head_kernel`, `head_bias`); a no-op on a model axis of
        one. Call it once, on the whole head, before the optimizer is
        built, so the momentum exists for the slice alone. A slice is
        marked `model_split`: the gradient all-reduce leaves it to its
        rank (`parallel.multihost.all_reduce_grads`)."""
        n_total = sum(self.n_classes)
        self.split = layout.head_kernel(n_total)
        if self.split is None:
            return self
        head = self.fused_head
        for name, dim in (("weight", self.split),
                          ("bias", layout.head_bias(n_total))):
            p = nn.Parameter(layout.shard(getattr(head, name), dim).clone())
            p.model_split = dim is not None
            setattr(head, name, p)
        return self

    def forward(self, features):
        x, w, b = features.float(), self.fused_head.weight, \
            self.fused_head.bias
        if self.split is None:
            logits = F.linear(x, w, b)
        elif self.split == 0:
            logits = multihost.model_gather(
                F.linear(multihost.model_copy(x), w, b))
        else:
            logits = multihost.model_sum(
                F.linear(multihost.model_slice(x), w)) + b
        return list(torch.split(logits, self.n_classes, dim=-1))


class MultiPartitioningClassifier(nn.Module):
    """Backbone + per-partitioning heads.

    forward(images NHWC) -> list of per-partitioning float32 logits, ordered
    coarse -> fine (the order of the partitioning files in the config).
    """

    def __init__(self, n_classes: Sequence[int], arch: str = "resnet50",
                 dtype=torch.bfloat16, remat=False):
        super().__init__()
        self.arch = arch
        self.backbone = build_backbone(arch, dtype=dtype, remat=remat)
        self.heads = MultiHeadClassifier(n_classes)

    def forward(self, images, train=False):
        return self.heads(self.backbone(images, train=train))

    def shard_(self, layout):
        """The fused head cut to this rank's slice (`MultiHeadClassifier.
        shard_`); the backbone stays replicated."""
        self.heads.shard_(layout)
        return self


def multi_head_cross_entropy(logits_list, labels, label_smoothing=0.0,
                             valid=None):
    """Sum of per-head cross-entropies.

    Args:
      logits_list: list of (B, C_p) float32 logits.
      labels: (P, B) or list of (B,) int labels per partitioning; -1 is
        ignored.
      valid: optional (P, B) or list of (B,) bool; invalid examples
        contribute zero loss.

    Each head's loss is the sum over its valid examples divided by
    max(#valid, 1); with label smoothing the log-likelihood is
    (1 - s) * log p[label] + s * mean(log p). Returns (total scalar,
    per-head list). In several processes #valid is the global batch's (the
    counts summed over the data axis first), so the local losses of the
    data ranks sum to the global batch's loss, as under the JAX package's
    GSPMD.
    """
    nlls, valids = [], []
    for p, logits in enumerate(logits_list):
        y = labels[p].long()
        logp_all = F.log_softmax(logits, dim=-1)
        logp = logp_all.gather(-1, y.clamp(min=0)[:, None])[:, 0]
        if label_smoothing > 0.0:
            logp = ((1.0 - label_smoothing) * logp
                    + label_smoothing * logp_all.mean(dim=-1))
        v = y >= 0
        if valid is not None:
            v = v & valid[p]
        nlls.append(torch.where(v, -logp, torch.zeros_like(logp)).sum())
        valids.append(v.sum())
    counts = multihost.device_sum(torch.stack(valids)).clamp(min=1)
    per_head = [nll / counts[p] for p, nll in enumerate(nlls)]
    return sum(per_head), per_head

"""Hierarchical multi-partitioning inference -- the f* rule -- in torch.

The port of `geoestimation_tpu/eval/infer.py`. Softmax each partitioning
head; for every cell of the finest partitioning, add the log-probabilities of
its ancestor cells in each coarser partitioning; argmax over fine cells; emit
that cell's mean lat/lng. The ancestor relations are precomputed gather maps
(`geo.hierarchy.Hierarchy`), so f* is gathers, sums and an argmax on the
device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class HierarchyArrays:
    """Device-resident constants derived from a `geo.hierarchy.Hierarchy`.

    Attributes:
      maps: tuple of (n_fine,) int64 ancestor gather maps, one per
        partitioning (last is identity).
      valid: (n_fine,) bool -- fine cells with ancestors in every coarser
        partitioning.
      lats, lngs: tuples of (n_classes_p,) float32 class center coordinates.
      names: partitioning short names, coarse -> fine.
    """

    maps: tuple
    valid: torch.Tensor
    lats: tuple
    lngs: tuple
    names: tuple = field(default=())

    @classmethod
    def from_hierarchy(cls, hierarchy, device="cpu"):
        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        return cls(
            maps=tuple(torch.as_tensor(m, dtype=torch.int64, device=device)
                       for m in hierarchy.maps),
            valid=torch.as_tensor(hierarchy.valid, device=device),
            lats=tuple(f32(p.lat) for p in hierarchy.partitionings),
            lngs=tuple(f32(p.lng) for p in hierarchy.partitionings),
            names=tuple(p.name for p in hierarchy.partitionings),
        )


def hierarchical_log_probs(logits_list, harrays: HierarchyArrays):
    """f* scores over fine cells: sum of ancestor log-probs. (B, n_fine)."""
    total = 0.0
    for logits, m in zip(logits_list, harrays.maps):
        lp = torch.log_softmax(logits.float(), dim=-1)
        total = total + lp.index_select(-1, m)
    # Fine cells lacking ancestors are excluded from the argmax.
    return torch.where(harrays.valid[None, :], total,
                       torch.tensor(-math.inf, device=total.device))


def predict_hierarchical(logits_list, harrays: HierarchyArrays):
    """f* prediction: (class, lat, lng) from the finest partitioning."""
    cls = torch.argmax(hierarchical_log_probs(logits_list, harrays), dim=-1)
    return cls, harrays.lats[-1][cls], harrays.lngs[-1][cls]


def predict_per_partitioning(logits_list, harrays: HierarchyArrays):
    """Per-head argmax predictions: list of (class, lat, lng) per
    partitioning."""
    out = []
    for logits, lat, lng in zip(logits_list, harrays.lats, harrays.lngs):
        cls = torch.argmax(logits, dim=-1)
        out.append((cls, lat[cls], lng[cls]))
    return out


def predict_all(logits_list, harrays: HierarchyArrays):
    """All predictions keyed like the reference output CSV: one entry per
    partitioning shortname plus 'hierarchy'."""
    preds = dict(zip(harrays.names,
                     predict_per_partitioning(logits_list, harrays)))
    preds["hierarchy"] = predict_hierarchical(logits_list, harrays)
    return preds


TTA_FOLDS = ("prob_mean", "log_mean", "logit_mean")


def mean_tta_logits(logits, n_crops, fold: str = "prob_mean"):
    """Fold a (B*n_crops, C) logits tensor back to (B, C) log-space scores
    over the TTA crops.

    fold modes:
      * "prob_mean" (default): log of the arithmetic mean of the crops'
        softmax probabilities -- the reference's convention.
      * "log_mean": mean of log-probabilities (geometric mean of probs).
      * "logit_mean": mean of raw logits.
    """
    x = logits.float().reshape(-1, n_crops, logits.shape[-1])
    if fold == "prob_mean":
        # log(mean_c softmax) == logsumexp_c(log_softmax) - log(n_crops)
        lp = torch.log_softmax(x, dim=-1)
        return torch.logsumexp(lp, dim=1) - math.log(float(n_crops))
    if fold == "log_mean":
        return torch.log_softmax(x, dim=-1).mean(dim=1)
    if fold == "logit_mean":
        return x.mean(dim=1)
    raise ValueError(f"unknown tta fold {fold!r}; have {TTA_FOLDS}")

"""Great-circle-distance metrics.

The port of `geoestimation_tpu/eval/metrics.py`: the fraction of test images
whose predicted coordinate lies within {1, 25, 200, 750, 2500} km
great-circle distance of the ground truth (reference README.md:167), as
float32 haversine distances and int counts that add across batches.
"""

from __future__ import annotations

import numpy as np
import torch

EARTH_RADIUS_KM = 6371.0
DEFAULT_THRESHOLDS_KM = (1.0, 25.0, 200.0, 750.0, 2500.0)


def great_circle_distance(lat1, lng1, lat2, lng2, radius_km=EARTH_RADIUS_KM):
    """Haversine distance in km between degree coordinates; broadcasts."""
    lat1, lng1, lat2, lng2 = (
        torch.deg2rad(torch.as_tensor(x, dtype=torch.float32))
        for x in (lat1, lng1, lat2, lng2)
    )
    dlat = lat2 - lat1
    dlng = lng2 - lng1
    a = (torch.sin(dlat / 2) ** 2
         + torch.cos(lat1) * torch.cos(lat2) * torch.sin(dlng / 2) ** 2)
    # Clamp for numerical safety at antipodes.
    a = torch.clamp(a, 0.0, 1.0)
    return radius_km * 2.0 * torch.arcsin(torch.sqrt(a))


def gcd_threshold_counts(pred_lat, pred_lng, true_lat, true_lng,
                         thresholds_km=DEFAULT_THRESHOLDS_KM, valid=None):
    """Per-threshold hit counts and total count for a batch.

    Returns (counts[T] int64 tensor, total int) -- counts, not fractions, so
    batches can be summed before dividing.
    """
    d = great_circle_distance(pred_lat, pred_lng, true_lat, true_lng)
    thr = torch.as_tensor(thresholds_km, dtype=torch.float32,
                          device=d.device)
    hits = d[..., None] <= thr
    if valid is not None:
        v = torch.as_tensor(valid, dtype=torch.bool, device=d.device)
        hits = hits & v[..., None]
        total = int(v.sum())
    else:
        total = d.numel()
    return hits.reshape(-1, thr.shape[0]).sum(dim=0), total


class GcdAccumulator:
    """Host-side accumulator over batches of counts."""

    def __init__(self, thresholds_km=DEFAULT_THRESHOLDS_KM):
        self.thresholds_km = tuple(thresholds_km)
        self.counts = np.zeros(len(self.thresholds_km), dtype="int64")
        self.total = 0

    def update(self, counts, total):
        self.counts = self.counts + np.asarray(
            torch.as_tensor(counts).cpu()).astype("int64")
        self.total = self.total + int(total)

    def result(self):
        denom = max(self.total, 1)
        acc = self.counts.astype(float) / denom
        return dict(zip(self.thresholds_km, acc.tolist()))

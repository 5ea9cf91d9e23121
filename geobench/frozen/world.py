"""Seeded inputs of the port's tools, frozen: the nested S2 partitionings at
the published class counts (`geoestimation_tpu_torch/tools/world.py`
`seeded_partitionings`) and the textured photo
(`geoestimation_tpu_torch/tools/make_demo_world.py` `textured_image`)."""

from __future__ import annotations

import io

import numpy as np

from . import s2

REAL_CLASS_COUNTS = (3298, 7202, 12893)   # coarse/middle/fine, published
NAMES = ("coarse", "middle", "fine")


def seeded_partitionings(rng, counts=REAL_CLASS_COUNTS):
    """Three nested S2 partitionings at `counts`: coarse level-6 cells under
    random points, then children of chosen cells, so that every fine cell
    has an ancestor in each coarser partitioning. Returns
    [(name, tokens, lat, lng)], coarse to fine; lat/lng are the cell
    centers in degrees (float64)."""
    n = 4 * counts[0] * 3
    lat = np.degrees(np.arcsin(rng.uniform(-1, 1, n)))
    lng = rng.uniform(-180, 180, n)
    ids = rng.choice(np.unique(s2.cell_id_at_level(lat, lng, 6)), counts[0],
                     replace=False)
    parts = []
    for name, k in zip(NAMES, counts):
        if parts:
            ids = rng.choice(s2.children(parts[-1][0]).ravel(), k,
                             replace=False)
        clat, clng = s2.cell_id_to_latlng(ids)
        parts.append((ids, name, s2.id_to_token(ids), clat, clng))
    return [p[1:] for p in parts]


def _upsample_f32(n, w, h):
    """Bilinear-upsample a (gh, gw) float grid to (h, w) via PIL."""
    from PIL import Image

    return np.asarray(
        Image.fromarray(n.astype(np.float32), mode="F").resize(
            (w, h), Image.BILINEAR))


def textured_image(rng, scene, cue, w=320, h=280, quality=88):
    """A natural-image-like (w x h) JPEG (the port's `textured_image` with
    its default `scene_style="color"`): multi-octave noise, a random
    luminance gradient, stripes (cue bit 0 vertical, bit 1 horizontal), a
    color cast per scene, sparse high-contrast blobs, pixel noise."""
    from PIL import Image

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.full((h, w, 3), 120.0, np.float32)
    for g, amp in [(4, 55), (8, 30), (16, 18), (48, 10)]:
        for c in range(3):
            base[..., c] += amp * _upsample_f32(rng.normal(0, 1, (g, g)), w, h)
    theta = rng.uniform(0, 2 * np.pi)
    grad = np.cos(theta) * xx / w + np.sin(theta) * yy / h
    base += rng.uniform(5, 45) * (grad - grad.mean())[..., None]
    period = max(6, w // 14)
    amp = rng.uniform(28, 48)
    phase = rng.uniform(0, 2 * np.pi)
    if cue & 1:
        base += amp * np.sin(2 * np.pi * xx / period + phase)[..., None]
    if cue & 2:
        base += amp * np.sin(2 * np.pi * yy / period + phase)[..., None]
    cast = [(22.0, 2.0, -14.0), (-12.0, 18.0, -10.0),
            (-8.0, -2.0, 20.0)][scene % 3]
    base += np.asarray(cast, np.float32)
    for _ in range(int(rng.integers(0, 4))):
        cx, cy = rng.integers(0, w), rng.integers(0, h)
        r = float(rng.integers(8, 28))
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2
        disk = np.exp(-d2 / (2 * (r / 2) ** 2))
        val = float(rng.choice([-1.0, 1.0]) * rng.uniform(70, 140))
        ch = int(rng.integers(0, 3))
        base[..., ch] += val * disk
    base += rng.normal(0, 5, (h, w, 3))
    arr = np.clip(base, 0, 255)
    buf = io.BytesIO()
    Image.fromarray(arr.astype(np.uint8)).save(buf, format="JPEG",
                                               quality=quality)
    return buf.getvalue()

"""The seeded full-width world that `chip_smoke.py` and the bench tools share.

`build_world()` gives a ResNet50 classifier at full width with three heads
at the published class counts 3298/7202/12893 (coarse/middle/fine), random
weights made from a seed in the JAX package's tree layout and passed through
the weights bridge (`convert.from_jax_variables`), and three nested S2
partitionings at those counts. Needs no data and no network. With
`n_scenes=3` it is an ISN world (`models/isn.py`): a scene head and
3 x (3298 + 7202 + 12893) = 70,179 scene geo-head outputs.

`forward(apply, harrays)` is the engine's own device pipeline around any
`apply`: eval_pipeline -> apply -> mean_tta_logits -> predict_all.

`write_shard_world(root, ...)` writes what the training CLI needs, made from
a seed: msgpack shards of JPEG records whose lat/lng lie in the partitionings'
fine cells, a label CSV for each split, the partitioning CSVs and a config
(Pillow makes the JPEGs).
"""

from __future__ import annotations

import copy
import io
import os

import numpy as np
import torch

from ..convert import from_jax_variables
from ..data import shards
from ..eval.infer import mean_tta_logits, predict_all
from ..geo import Partitioning, assign_classes, s2
from ..ingest.pipeline import eval_pipeline
from ..models.resnet import FEATURE_DIM, STAGE_SIZES
from ..utils.config import Config, save_config

SEED = 0
ARCH = "resnet50"
REAL_CLASS_COUNTS = (3298, 7202, 12893)   # coarse/middle/fine, published


def seeded_partitionings(rng, counts=REAL_CLASS_COUNTS):
    """Three nested S2 partitionings at the published class counts: coarse
    level-6 cells under random points, then children of chosen cells, so
    every fine cell has an ancestor in each coarser partitioning."""
    n = 4 * counts[0] * 3
    lat = np.degrees(np.arcsin(rng.uniform(-1, 1, n)))
    lng = rng.uniform(-180, 180, n)
    ids = rng.choice(np.unique(s2.cell_id_at_level(lat, lng, 6)), counts[0],
                     replace=False)
    parts = []
    for name, k in zip(("coarse", "middle", "fine"), counts):
        if parts:
            ids = rng.choice(s2.children(parts[-1].cell_ids).ravel(), k,
                             replace=False)
        clat, clng = s2.cell_id_to_latlng(ids)
        parts.append(Partitioning(name=name, tokens=s2.id_to_token(ids),
                                  lat=clat, lng=clng,
                                  counts=np.zeros(k, np.int64)))
    return parts


def seeded_jax_variables(rng, arch, n_classes, n_scenes=None):
    """Random weights in the JAX package's tree layout (numpy): He-normal
    HWIO kernels, BatchNorm with unit-scale statistics and small residual
    scales (bn3) so 16 blocks stay in range. With `n_scenes`, ISN's heads
    (`scene_head`, `scene_geo_heads`) in place of the fused head; the scene
    head's bias is zero, so the features alone pick each row's scene."""
    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std))

    def conv(k, cin, cout):
        return {"kernel": normal((k, k, cin, cout), (2.0 / (k * k * cin)) ** .5)}

    def bn(c, lo=0.5, hi=1.0):
        return ({"scale": rng.uniform(lo, hi, c).astype(np.float32),
                 "bias": normal((c,), 0.1)},
                {"mean": normal((c,), 0.1),
                 "var": rng.uniform(0.5, 1.5, c).astype(np.float32)})

    params, stats = {"conv1": conv(7, 3, 64)}, {}
    params["bn1"], stats["bn1"] = bn(64)
    cin = 64
    for stage, n_blocks in enumerate(STAGE_SIZES[arch]):
        mid = 64 * 2 ** stage
        for b in range(n_blocks):
            name = f"layer{stage + 1}_block{b}"
            p = {"conv1": conv(1, cin, mid), "conv2": conv(3, mid, mid),
                 "conv3": conv(1, mid, 4 * mid)}
            s = {}
            p["bn1"], s["bn1"] = bn(mid)
            p["bn2"], s["bn2"] = bn(mid)
            p["bn3"], s["bn3"] = bn(4 * mid, 0.1, 0.3)
            if b == 0:
                p["downsample_conv"] = conv(1, cin, 4 * mid)
                p["downsample_bn"], s["downsample_bn"] = bn(4 * mid)
            params[name], stats[name] = p, s
            cin = 4 * mid
    def linear(n_out, bias_std=0.1):
        return {"kernel": normal((FEATURE_DIM, n_out), FEATURE_DIM ** -0.5),
                "bias": normal((n_out,), bias_std)}

    if n_scenes:
        heads = {"scene_head": linear(n_scenes, 0.0),
                 "scene_geo_heads": linear(n_scenes * sum(n_classes))}
    else:
        heads = {"heads": {"fused_head": linear(sum(n_classes))}}
    return {"backbone": params, **heads}, {"backbone": stats}


def build_world(seed=SEED, arch=ARCH, counts=REAL_CLASS_COUNTS,
                n_scenes=None):
    """(config, state_dict, partitionings) made from `seed`; the weights go
    through the weights bridge from the JAX layout. `n_scenes`: an ISN
    world (scene-gated config and heads)."""
    rng = np.random.default_rng(seed)
    parts = seeded_partitionings(rng, counts)
    params, stats = seeded_jax_variables(rng, arch, counts, n_scenes)
    config = Config()
    config.model_params.arch = arch
    if n_scenes:
        config.model_params.scene_gating = True
        config.model_params.n_scenes = n_scenes
    return config, from_jax_variables(params, stats, arch, counts), parts


def scene_images(rng, n, size=256):
    """n seeded uint8 (size, size, 3) images of three families, image i of
    family i % 3 (an ISN world's scenes): a dark vertical gradient, green
    noise, gray vertical stripes, each under pixel noise of its own."""
    ramp = np.linspace(0, 1, size, dtype=np.float32)
    stripes = np.sign(np.sin(2 * np.pi * ramp * size / 16))
    out = np.empty((n, size, size, 3), np.float32)
    for i in range(n):
        family = i % 3
        if family == 0:
            base = (40 + 120 * ramp)[:, None, None] * np.ones((1, size, 3))
        elif family == 1:
            base = np.array([60, 150, 50], np.float32) + rng.normal(
                0, 40, (size, size, 3))
        else:
            base = (128 + 60 * stripes)[None, :, None] * np.ones((size, 1, 3))
        out[i] = base + rng.normal(0, 12, (size, size, 3))
    return np.clip(out, 0, 255).astype(np.uint8)


def fit_scene_head(state_dict, feats, scenes, margin=4.0):
    """Sets an ISN state dict's scene head to the nearest-mean classifier
    of float32 pooled features `feats` (N, F) labelled `scenes` (N,), so
    that each family of `scene_images` routes to its own scene: row s is
    c (mu_s - mu), bias -c (mu_s - mu) . (mu_s + mu) / 2 (mu_s the family
    means, mu their mean), with c putting `margin` between the closest two
    family means. Returns the state dict."""
    feats = feats.double().cpu()
    mus = torch.stack([feats[scenes == s].mean(0)
                       for s in range(int(scenes.max()) + 1)])
    mu = mus.mean(0)
    closest = min(float(((mus[s] - mus[t]) ** 2).sum())
                  for s in range(len(mus)) for t in range(s))
    c = 2 * margin / closest
    state_dict["scene_head.weight"] = (c * (mus - mu)).float()
    state_dict["scene_head.bias"] = (
        -c * ((mus - mu) * (mus + mu)).sum(1) / 2).float()
    return state_dict


def family_classes(n_classes, n_families=3):
    """The class each image family is fit to in each head (`fit_heads`):
    family s to class s * (C // n_families) of a head of C classes."""
    return [[s * (c // n_families) for s in range(n_families)]
            for c in n_classes]


def fit_heads(state_dict, feats, families, n_classes, margin=4.0):
    """Sets a classifier state dict's fused head so that each family of
    `scene_images` has a decisive class of its own in every head: in each
    head, the rows of `family_classes` are the nearest-mean classifier of
    float32 pooled features `feats` (N, F) labelled `families` (N,), as
    `fit_scene_head` builds it (`margin` between the closest two family
    means), and every other row and bias is zero. Returns the state dict."""
    probe = {"scene_head.weight": None, "scene_head.bias": None}
    fit_scene_head(probe, feats, families, margin)
    weight = torch.zeros_like(state_dict["heads.fused_head.weight"])
    bias = torch.zeros_like(state_dict["heads.fused_head.bias"])
    offset = 0
    for c, classes in zip(n_classes, family_classes(n_classes)):
        for s, k in enumerate(classes):
            weight[offset + k] = probe["scene_head.weight"][s]
            bias[offset + k] = probe["scene_head.bias"][s]
        offset += c
    state_dict["heads.fused_head.weight"] = weight
    state_dict["heads.fused_head.bias"] = bias
    return state_dict


def forward(apply, harrays, n_crops=10, crop=224, fold="prob_mean"):
    """uint8 (B, base, base, 3) device tensor -> {p_key: (cls, lat, lng)}
    through `apply`, as `InferenceEngine` runs its fast path."""
    @torch.inference_mode()
    def run(images_u8):
        x = eval_pipeline(images_u8, n_crops=n_crops, crop=crop,
                          dtype=torch.bfloat16)
        logits = [mean_tta_logits(l, n_crops, fold=fold) for l in apply(x)]
        return predict_all(logits, harrays)

    return run


def _jpeg(rng, image_mod, side):
    """A smooth seeded (side x side') JPEG: a coarse random color grid,
    upsampled, under pixel noise."""
    w, h = side, int(rng.integers(side, side + 64))
    grid = rng.integers(0, 256, (4, 4, 3), dtype=np.uint8)
    img = np.asarray(image_mod.fromarray(grid).resize(
        (w, h), image_mod.BILINEAR), np.int16)
    img = np.clip(img + rng.integers(-12, 13, img.shape, dtype=np.int16),
                  0, 255)
    buf = io.BytesIO()
    image_mod.fromarray(img.astype(np.uint8)).save(buf, format="JPEG",
                                                   quality=90)
    return buf.getvalue()


def write_shard_world(root, partitionings, config=None, seed=SEED,
                      train_shards=2, per_shard=256, n_val=64,
                      sizes=(256, 320)):
    """Writes a training world under `root` and returns its config path:
    `train_shards` x `per_shard` training records and `n_val` validation
    records (msgpack, `data/shards.py`), JPEGs with shorter sides drawn
    from `sizes`, each at the center of a random fine cell of
    `partitionings`; `{train,val}_labels.csv` (IMG_ID and one class column
    per partitioning, from `assign_classes`); the partitionings as CSVs; and
    `world.yml`: `config` (default `Config()`) with those files, the
    checkpoint dir `root/ckpt` and `seed`."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    fine = partitionings[-1]
    files = []
    for p in partitionings:
        files.append(os.path.join(root, "cells", f"{p.name}.csv"))
        p.to_csv(files[-1])

    def split(name, n_shards, n):
        ids, lat, lng = [], [], []
        for s in range(n_shards):
            cells = rng.integers(0, len(fine), n)
            recs = [{"id": f"{name}_{s}_{i}",
                     "image": _jpeg(rng, Image, int(rng.integers(*sizes))),
                     "lat": float(fine.lat[c]), "lng": float(fine.lng[c])}
                    for i, c in enumerate(cells)]
            shards.write_shard(recs, os.path.join(
                root, name, f"shard_{s:05d}.msgpack"))
            ids += [r["id"] for r in recs]
            lat += [r["lat"] for r in recs]
            lng += [r["lng"] for r in recs]
        labels = assign_classes(lat, lng, partitionings)
        if (labels < 0).any():
            raise RuntimeError("a record lies outside the partitionings")
        path = os.path.join(root, f"{name}_labels.csv")
        with open(path, "w") as f:
            f.write(",".join(["IMG_ID"] + [p.name for p in partitionings])
                    + "\n")
            for i, row in zip(ids, labels.T):
                f.write(",".join([i] + [str(int(c)) for c in row]) + "\n")
        return [os.path.join(root, name, "*.msgpack")], path

    train, train_labels = split("train", train_shards, per_shard)
    val, val_labels = split("val", 1, n_val)
    config = copy.deepcopy(config or Config())
    mp, tp = config.model_params, config.train_params
    mp.partitionings.files = files
    mp.partitionings.shortnames = [p.name for p in partitionings]
    tp.train_shards, tp.val_shards = train, val
    tp.train_labels, tp.val_labels = train_labels, val_labels
    tp.checkpoint_dir = os.path.join(root, "ckpt")
    tp.seed = seed
    path = os.path.join(root, "world.yml")
    save_config(config, path)
    return path

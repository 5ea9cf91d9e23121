"""The training and evaluation steps.

The port of `geoestimation_tpu/train/step.py`: augment (on the device, the
draws from `(seed, step)`) -> forward in train mode -> the sum of the
heads' cross-entropies -> backward -> the optimizer's update, which also
advances the step. Parameters and gradients stay float32 while the backbone
computes in its dtype; bf16 needs no loss scaling, and the JAX step has
none. Metrics stay on the device until the caller reads them.

In several processes (`parallel/multihost.py`) each process steps on the
rows of its data index of the global batch: the BatchNorm statistics and
the loss's valid counts are the global batch's, the gradients are summed
over the data axis (one all-reduce of the flattened gradients after the
backward, two with `dcn_data`) before the update, the draws are the global
batch's, and the reported metrics are the global figures. With a model
axis the ranks of one data index step on the same rows, each with its
slice of the fused head (`models/classifier.py`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ingest.pipeline import center_crop, normalize, train_pipeline
from ..models.classifier import multi_head_cross_entropy
from ..models.isn import isn_loss, route_rows
from ..parallel import multihost
from ..utils.spans import span
from .optim import Optimizer


@dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer and
    the number of steps taken."""

    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0


def _inputs(state, images_u8, seed, crop, augment, crop_scale, draws):
    dtype = state.model.backbone.dtype
    if augment:
        shard = multihost.data_shard()
        return train_pipeline(images_u8, seed, state.step, crop=crop,
                              dtype=dtype, crop_scale=crop_scale, draws=draws,
                              shard=shard)
    return normalize(center_crop(images_u8, crop), dtype)


def _update(state, loss):
    state.optimizer.zero_grad()
    with span("train.backward", device=True):
        loss.backward()
    with span("train.all_reduce"):
        multihost.all_reduce_grads(state.optimizer.params)
    with span("train.optimizer", device=True):
        state.optimizer.step()
    state.step += 1


def _n_valid(labels):
    return (labels >= 0).all(dim=0).sum()


def _metrics(total, parts, labels):
    """loss, the parts and n_valid, detached and summed over the data axis
    in one all-reduce (none in one process)."""
    metrics = {k: v.detach() for k, v in {"loss": total, **parts}.items()}
    names = sorted(metrics)
    summed = multihost.device_sum(torch.stack(
        [metrics[k] for k in names] + [_n_valid(labels).float()]))
    return {**{k: summed[i] for i, k in enumerate(names)},
            "n_valid": summed[-1].long()}


def train_step(state: TrainState, images_u8, labels, seed: int,
               label_smoothing: float = 0.0, crop: int = 224,
               augment: bool = True, crop_scale=None, draws=None):
    """One optimization step, in place. images_u8: (B, base, base, 3) uint8;
    labels: (P, B) int with -1 = ignore; seed: the run's seed (the draws
    come from it and the step unless `draws` are given, see
    `ingest.pipeline.crop_draws`; `draws` are this process's rows).
    augment=False takes the center crop. Returns (state, metrics): loss,
    loss_head{i}, n_valid."""
    with span("train.forward", device=True):
        x = _inputs(state, images_u8, seed, crop, augment, crop_scale, draws)
        total, per_head = multi_head_cross_entropy(
            state.model(x, train=True), labels,
            label_smoothing=label_smoothing)
    _update(state, total)
    return state, _metrics(total, {f"loss_head{i}": l
                                   for i, l in enumerate(per_head)}, labels)


@torch.no_grad()
def eval_step(state: TrainState, images_u8, labels, crop: int = 224):
    """Validation loss on center crops, with the running statistics.
    Returns (metrics, logits). In several processes each rank's val_loss is
    its share of the global batch's (the Trainer sums the shares)."""
    x = normalize(center_crop(images_u8, crop), state.model.backbone.dtype)
    logits = state.model(x)
    total, per_head = multi_head_cross_entropy(logits, labels)
    return {
        "val_loss": total,
        **{f"val_loss_head{i}": l for i, l in enumerate(per_head)},
    }, logits


def train_step_isn(state: TrainState, images_u8, labels, scene, seed: int,
                   label_smoothing: float = 0.0, crop: int = 224,
                   scene_loss_weight: float = 1.0, augment: bool = True,
                   crop_scale=None, draws=None):
    """ISN optimization step: scene CE + geo CE on the ground-truth-scene
    heads (`models.isn.isn_loss`). scene: (B,) int, -1 = unknown."""
    with span("train.forward", device=True):
        x = _inputs(state, images_u8, seed, crop, augment, crop_scale, draws)
        scene_logits, heads = state.model.with_scene(x, train=True)
        total, comps = isn_loss(scene_logits, heads, labels, scene,
                                scene_loss_weight=scene_loss_weight,
                                label_smoothing=label_smoothing)
    _update(state, total)
    return state, _metrics(total, {"scene_loss": comps["scene_loss"],
                                   "geo_loss": comps["geo_loss"]}, labels)


@torch.no_grad()
def eval_step_isn(state: TrainState, images_u8, labels, scene,
                  crop: int = 224):
    """ISN validation: geo loss on the predicted-scene heads (the routing
    used at inference) and scene-classification counts (scene -1 is left
    out). Returns (metrics, routed logits)."""
    x = normalize(center_crop(images_u8, crop), state.model.backbone.dtype)
    scene_logits, heads = state.model.with_scene(x)
    route = scene_logits.argmax(-1)
    gated = [route_rows(h, route) for h in heads]
    total, per_head = multi_head_cross_entropy(gated, labels)
    s_valid = scene >= 0
    return {
        "val_loss": total,
        **{f"val_loss_head{i}": l for i, l in enumerate(per_head)},
        "scene_correct": ((route == scene) & s_valid).sum(),
        "scene_total": s_valid.sum(),
    }, gated

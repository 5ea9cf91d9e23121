"""Feature-TTA self-distillation: make the fast TTA mode budget-safe.

The port of `geoestimation_tpu/models/tta_distill.py`. Feature-space
ten-crop TTA (`fast_infer.build_feature_tta_apply`, int8 twin in
`models/quant.py`) runs the trunk once per base image instead of once per
crop, but is approximate at crop borders: the trunk's features see real
neighbour pixels where the exact path sees the crop's padding.

This module fine-tunes the checkpoint so the approximate forward matches
the exact one (self-distillation, no labels): the student is the
feature-TTA forward, the teacher the exact ten-crop forward of the frozen
initial weights, the loss the per-head KL of the TTA-folded probabilities
(what the f* rule consumes), plus an anchor on the exact path. The export
is a standard identity-BN checkpoint (`qat.unfold_to_variables`).

Both forwards run in float32 on the folded network of `models/qat.py`
(`fold_variables`), in the (pixel - 128) input domain with the serving
paths' explicit paddings; the feature-TTA geometry is the one copy in
`models/fast_infer.py`. They run on cuDNN through autograd and launch none
of the hand-written kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..eval.infer import mean_tta_logits
from ..ingest.pipeline import make_crops
from .fast_infer import (
    check_feature_tta,
    check_square,
    ftta_mirror_concat,
    ftta_windows,
)
from .qat import _stem_input, backward_and_step, rounded_pad_val
from .quant import _folded_conv
from .resnet import STAGE_SIZES


def folded_stem(folded, x):
    """(B, S, S, 3) float32 (pixel - 128) -> the pooled stem output, NCHW;
    the borders padded as the serving paths pad them (`qat.rounded_pad_val`:
    the dataset mean, rounded)."""
    pad_val = torch.from_numpy(rounded_pad_val()).to(x.device)
    y = _folded_conv(_stem_input(x, pad_val), folded["stem"], 2)
    return F.max_pool2d(torch.relu(y), 3, stride=2, padding=1)


def folded_stage(folded, y, stage):
    """One ResNet stage (torchvision layout) of the folded network."""
    prefix = f"layer{stage + 1}_"
    for name, stride, fb in folded["blocks"]:
        if not name.startswith(prefix):
            continue
        h = torch.relu(_folded_conv(y, fb["conv1"]))
        h = torch.relu(_folded_conv(h, fb["conv2"], stride, 1))
        h3 = _folded_conv(h, fb["conv3"])
        res = (_folded_conv(y, fb["downsample"], stride)
               if "downsample" in fb else y)
        y = torch.relu(h3 + res)
    return y


def folded_head(folded, y, n_classes):
    """The fused head on the pooled features (the JAX package's form: fused
    head only)."""
    head = folded["heads"]["fused_head"]
    logits = y.mean(dim=(2, 3)) @ head["kernel"] + head["bias"]
    if n_classes is None:
        return logits
    return list(torch.split(logits, tuple(n_classes), dim=-1))


def build_exact_tta_apply(arch, n_classes, crop=224, n_crops=10):
    """`apply(folded, base_m128) -> [per-head logits (B*n_crops, C_p)]`: the
    exact path, pixel crops of the (B, S, S, 3) base (the geometry of
    `ingest.pipeline.make_crops`), the full network per crop."""
    n_stages = len(STAGE_SIZES[arch])

    def apply(folded, base_m128):
        crops = make_crops(base_m128, n_crops, crop)
        y = folded_stem(folded, crops.reshape((-1,) + crops.shape[-3:]))
        for stage in range(n_stages):
            y = folded_stage(folded, y, stage)
        return folded_head(folded, y, n_classes)

    return apply


def build_ftta_apply(arch, n_classes, level=3, crop=224, n_crops=10):
    """`apply(folded, base_m128) -> [per-head logits (B*n_crops, C_p)]`: the
    feature-TTA student. The stem and stages 1..level run once on the base
    (and its mirror for n_crops=10); the crop-aligned windows of that
    stage's map run the remaining stages and the head
    (`fast_infer.ftta_mirror_concat`, `ftta_windows`)."""
    n_stages = len(STAGE_SIZES[arch])
    check_feature_tta(n_crops, level, n_stages)

    def apply(folded, base_m128):
        b, s = check_square(base_m128)
        y = folded_stem(folded, ftta_mirror_concat(base_m128, n_crops))
        for stage in range(level):
            y = folded_stage(folded, y, stage)
        xc = ftta_windows(y.permute(0, 2, 3, 1), b, s, crop, n_crops, level)
        xc = xc.permute(0, 3, 1, 2)
        for stage in range(level, n_stages):
            xc = folded_stage(folded, xc, stage)
        return folded_head(folded, xc, n_classes)

    return apply


def _fold_log_probs(logits, n_crops, tta_fold):
    return [torch.log_softmax(mean_tta_logits(l, n_crops, tta_fold), dim=-1)
            for l in logits]


@torch.no_grad()
def teacher_log_probs(exact_apply, folded, base_u8, n_crops,
                      tta_fold="prob_mean"):
    """The frozen teacher's per-head TTA-folded log-probs of one base batch
    (computed once per batch: the teacher never changes)."""
    return tuple(_fold_log_probs(
        exact_apply(folded, base_u8.float() - 128.0), n_crops, tta_fold))


def _kl_terms(teacher_lp, student_lp):
    kls, agrees = [], []
    for t, s in zip(teacher_lp, student_lp):
        kls.append(torch.mean(torch.sum(torch.exp(t) * (t - s), dim=-1)))
        agrees.append(torch.mean((t.argmax(-1) == s.argmax(-1)).float()))
    return kls, agrees


def make_distill_step(ftta_apply, optimizer, n_crops, tta_fold="prob_mean",
                      train_scope="all", level=3, arch="resnet50",
                      exact_apply=None, anchor_weight=1.0):
    """Returns `step(folded, base_u8, teacher_lp) -> metrics`, updating the
    leaves of `folded` in place through `optimizer` (over
    `qat.folded_leaves(folded)`).

    Loss: the sum over heads of KL(teacher || feature-TTA student), plus,
    with `exact_apply`, `anchor_weight` x KL(teacher || exact student), on
    TTA-folded probabilities. metrics: kl, kl_anchor, kl_head{i},
    agree_head{i} (post-fold argmax agreement), detached.

    train_scope: 'all' trains everything; 'rest' zeroes the gradients of the
    stem and stages 1..level (the leaves stay in the optimizer, whose
    counts advance as optax's do)."""
    if train_scope not in ("all", "rest"):
        raise ValueError("train_scope must be 'all' or 'rest'")
    frozen = set()
    if train_scope == "rest":
        frozen = {f"layer{s + 1}_block{b}" for s in range(level)
                  for b in range(STAGE_SIZES[arch][s])}

    def frozen_leaves(folded):
        if train_scope == "all":
            return []
        out = list(folded["stem"])
        for name, _, fb in folded["blocks"]:
            if name in frozen:
                out += [t for kb in fb.values() for t in kb]
        return out

    def step(folded, base_u8, teacher_lp):
        x = base_u8.float() - 128.0
        kls, agrees = _kl_terms(
            teacher_lp, _fold_log_probs(ftta_apply(folded, x), n_crops,
                                        tta_fold))
        loss = sum(kls)
        anchor = torch.zeros((), device=x.device)
        if exact_apply is not None:
            a_kls, _ = _kl_terms(
                teacher_lp, _fold_log_probs(exact_apply(folded, x), n_crops,
                                            tta_fold))
            anchor = sum(a_kls)
            loss = loss + anchor_weight * anchor
        backward_and_step(optimizer, loss, frozen_leaves(folded))
        metrics = {"kl": sum(kls).detach(), "kl_anchor": anchor.detach()}
        for i, (k, a) in enumerate(zip(kls, agrees)):
            metrics[f"kl_head{i}"] = k.detach()
            metrics[f"agree_head{i}"] = a
        return metrics

    return step


def make_eval_kl(ftta_apply, exact_apply, n_crops, tta_fold="prob_mean"):
    """Returns `eval_kl(folded, base_u8, teacher_lp) -> (kl_ftta, kl_exact)`,
    the verdict pair on one batch, without gradients."""

    @torch.no_grad()
    def eval_kl(folded, base_u8, teacher_lp):
        x = base_u8.float() - 128.0
        kls, _ = _kl_terms(teacher_lp, _fold_log_probs(
            ftta_apply(folded, x), n_crops, tta_fold))
        e_kls, _ = _kl_terms(teacher_lp, _fold_log_probs(
            exact_apply(folded, x), n_crops, tta_fold))
        return sum(kls), sum(e_kls)

    return eval_kl

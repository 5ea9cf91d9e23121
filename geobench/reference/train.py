"""The baseM training step in float32: the augmentation, the classifier in
train mode, the heads' loss, and SGD with momentum and weight decay.

Written from the recipe (`configs/baseM.yml`) and its stated semantics, not
from the port's code: the decoded photo (`decode.py`) -> one random resized
crop size per step, drawn with each row's offsets and flips from
`(seed, step)` -> the window resized to the crop with an antialiased
triangle filter, flipped, clipped -> ImageNet normalization -> the ResNet
with every BatchNorm on the batch's own statistics (biased variance) -> the
sum over the heads of each head's mean cross-entropy -> the gradient ->
u = g + wd * p, t = momentum * t + u, p -= lr(count) * t, with a linear
warm-up of the learning rate over the first half epoch and its decay at
the milestones. TF32 off.

`quant`, where given, rounds each convolution's and the head's inputs and
weights (`quant(t, "act")`, `quant(t, "weight")`), the gradient of its
output (`quant(t, "grad")`), and every activation the recipe holds in
bf16: the control below the recipe's bf16, `quant.fp8_training`. `rows`, where given, keeps only the
first `rows` of each batch: the fault of half the batch left out."""

from __future__ import annotations

import bisect
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import model

TRAINABLE = ("weight", "bias")


def lr_at(recipe, steps_per_epoch, count):
    """The learning rate of update `count` (from 0)."""
    warm = (max(1, int(recipe["warmup_epochs"] * steps_per_epoch))
            if recipe["warmup_epochs"] > 0 else 0)
    if count < warm:
        return recipe["lr"] * count / warm
    bounds = sorted({int(m * steps_per_epoch) - warm
                     for m in recipe["milestones"]})
    return recipe["lr"] * recipe["gamma"] ** bisect.bisect_right(
        bounds, count - warm)


def step_generator(seed, step):
    """The CPU generator of one step's draws, from `(seed, step)` alone."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(
        (int(state[0]) << 31 | int(state[1])) & (2 ** 63 - 1))


def crop_sizes(base, scale, n_sizes=8):
    lo = max(1, int(np.floor(base * float(scale[0]) ** 0.5)))
    hi = min(base, int(np.ceil(base * float(scale[1]) ** 0.5)))
    return sorted({int(round(s)) for s in np.linspace(lo, hi, n_sizes)})


def draws(seed, step, b, base, scale):
    """(window side, tops, lefts, flips) of one step's b rows: the side
    drawn once for the step among `crop_sizes`, each row's offsets scaled
    from uniform draws to the free range."""
    gen = step_generator(seed, step)
    sizes = crop_sizes(base, scale)
    size = sizes[int(torch.randint(len(sizes), (), generator=gen))]
    off = torch.rand(b, 2, generator=gen)
    tops = (off[:, 0] * (base - size + 1)).long()
    lefts = (off[:, 1] * (base - size + 1)).long()
    flips = torch.rand(b, generator=gen) < 0.5
    return size, tops, lefts, flips


def triangle(n_in, n_out):
    """(n_in, n_out) float32 weights of a bilinear resize that widens its
    triangle by the scale when it shrinks, each output's weights summing
    to 1 (sample points at pixel centers)."""
    scale = np.float32(n_in / n_out)
    width = max(scale, np.float32(1.0))
    at = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * scale \
        - np.float32(0.5)
    d = np.abs(at[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0), np.float32(1) - d / width)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(total > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (at >= -0.5) & (at <= n_in - 0.5)
    return torch.from_numpy(np.where(inside[None, :], w, 0)
                            .astype(np.float32))


def augment(images_u8, seed, step, crop, scale):
    """uint8 (B, S, S, 3) on the device -> normalized float32 NCHW
    (B, 3, crop, crop): the recipe's random resized crop (area `scale`)
    and flip."""
    b, s = images_u8.shape[0], images_u8.shape[1]
    size, tops, lefts, flips = draws(seed, step, b, s, scale)
    x = torch.stack([images_u8[i, t:t + size, l:l + size]
                     for i, (t, l) in enumerate(zip(tops.tolist(),
                                                    lefts.tolist()))])
    w = triangle(size, crop).to(images_u8.device)
    x = torch.einsum("bhwc,hH,wW->bHWc", x.float(), w, w)
    x = torch.where(flips.to(x.device)[:, None, None, None], x.flip(2), x)
    x = x.clamp(0.0, 255.0).permute(0, 3, 1, 2)
    mean = torch.tensor(model.MEAN, device=x.device).view(1, 3, 1, 1) * 255
    std = torch.tensor(model.STD, device=x.device).view(1, 3, 1, 1) * 255
    return (x - mean) / std


def _bn(x, p, name, quant=None):
    y = F.batch_norm(x, None, None, p[f"{name}.weight"], p[f"{name}.bias"],
                     training=True, eps=model.BN_EPS)
    return y if quant is None else quant(y, "act")


def _conv(x, p, name, quant, stride=1, padding=0):
    w = p[f"{name}.weight"]
    if quant is None:
        return F.conv2d(x, w, None, stride, padding)
    y = F.conv2d(quant(x, "act"), quant(w, "weight"), None, stride, padding)
    return quant(quant(y, "grad"), "act")


def forward(x, p, arch, quant=None):
    """Train-mode logits (N, sum of the class counts) of NCHW float32 x.
    With `quant`, every tensor the recipe holds in bf16 between operations
    (each convolution's output, each BatchNorm's, each block's sum) is
    rounded by it too."""
    b = "backbone"
    x = torch.relu(_bn(_conv(x, p, f"{b}.conv1", quant, 2, 3), p,
                       f"{b}.bn1", quant))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage, n_blocks in enumerate(model.STAGE_SIZES[arch]):
        for i in range(n_blocks):
            q = f"{b}.layer{stage + 1}.{i}"
            s = 2 if stage > 0 and i == 0 else 1
            y = torch.relu(_bn(_conv(x, p, f"{q}.conv1", quant), p,
                               f"{q}.bn1", quant))
            y = torch.relu(_bn(_conv(y, p, f"{q}.conv2", quant, s, 1), p,
                               f"{q}.bn2", quant))
            y = _bn(_conv(y, p, f"{q}.conv3", quant), p, f"{q}.bn3", quant)
            if f"{q}.downsample.0.weight" in p:
                x = _bn(_conv(x, p, f"{q}.downsample.0", quant, s), p,
                        f"{q}.downsample.1", quant)
            x = torch.relu(y + x)
            if quant is not None:
                x = quant(x, "act")
    feats = x.mean(dim=(2, 3))
    w, bias = p["heads.fused_head.weight"], p["heads.fused_head.bias"]
    if quant is None:
        return F.linear(feats, w, bias)
    return quant(F.linear(quant(feats, "act"), quant(w, "weight"), bias),
                 "grad")


def loss(logits, labels, sizes):
    """The sum over the heads of each head's mean cross-entropy over its
    rows with a label (labels (P, B), -1 = none)."""
    total = 0.0
    for head, y in zip(torch.split(logits, sizes, dim=-1), labels):
        valid = y >= 0
        nll = F.cross_entropy(head, y.clamp(min=0), reduction="none")
        total = total + torch.where(valid, nll, 0).sum() / max(
            1, int(valid.sum()))
    return total


def trainable(sd):
    return {k: v for k, v in sd.items() if k.rsplit(".", 1)[-1] in TRAINABLE}


def steps(sd, batches, arch, sizes, recipe, steps_per_epoch, seed,
          quant=None, rows=None):
    """Follows `len(batches)` training steps from the float32 state dict
    `sd` (not changed). batches: [(uint8 (B, S, S, 3) on the device,
    (P, B) int64 labels)]. Returns {"losses": [float], "grad0": {leaf:
    the first step's gradient}, "params": {leaf: value after the last
    step}}, leaves on the host."""
    model.no_tf32()
    params = {k: v.detach().clone() for k, v in trainable(sd).items()}
    traces = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad0 = [], None
    for count, (images, labels) in enumerate(batches):
        if rows is not None:
            images, labels = images[:rows], labels[:, :rows]
        x = augment(images, seed, count, recipe["image_size"],
                    recipe["crop_scale"])
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        total = loss(forward(x, leaves, arch, quant), labels, sizes)
        grads = dict(zip(leaves, torch.autograd.grad(total,
                                                     list(leaves.values()))))
        losses.append(float(total.detach()))
        if grad0 is None:
            grad0 = {k: g.cpu() for k, g in grads.items()}
        lr = lr_at(recipe, steps_per_epoch, count)
        with torch.no_grad():
            for k, p in params.items():
                u = grads[k] + recipe["weight_decay"] * p
                traces[k].mul_(recipe["momentum"]).add_(u)
                params[k] = p.detach() - lr * traces[k]
        del x, total, grads, leaves
    return {"losses": losses, "grad0": grad0,
            "params": {k: v.cpu() for k, v in params.items()}}


def judge(program, reference, sd0, weight_decay):
    """The readings of the program's steps against the reference's.

    program: {"losses", "trace1": {leaf: the momentum trace after the
    first step}, "params": {leaf: after the last step}}. The first gradient
    as the program's optimizer got it is trace1 - wd * p0 (the first trace
    is u = g + wd * p). A leaf's gap is |program's norm - reference's
    norm|, over the reference's norm of that leaf or of the median leaf,
    whichever is larger. Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out of the change (they move
    by round-off alone). Returns {"loss_gap" (the worst step's relative
    gap), "grad_gap_median", "change_gap_median" (the median leaf's gap),
    "grad_gap_worst", "change_gap_worst" (the worst leaf's),
    "grad_diff_median" (the median leaf's |program's first gradient -
    reference's| over the reference's norm: it keeps the elementwise
    rounding that norms and the mean loss average away; read for PERF.md,
    not compared),
    "leaves_left_out"}."""
    leaves = sorted(reference["grad0"])
    p0 = {k: sd0[k].detach().double().cpu() for k in leaves}
    g_ref = {k: float(reference["grad0"][k].double().norm()) for k in leaves}
    g_prog = {k: float((program["trace1"][k].double()
                        - weight_decay * p0[k]).norm()) for k in leaves}
    med_g = float(np.median(list(g_ref.values())))
    kept = [k for k in leaves if g_ref[k] >= 1e-3 * med_g]
    d_ref = {k: float((reference["params"][k].double() - p0[k]).norm())
             for k in kept}
    d_prog = {k: float((program["params"][k].double() - p0[k]).norm())
              for k in kept}
    med_d = float(np.median(list(d_ref.values())))

    def gaps(prog, ref, med, keys):
        return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                for k in keys]

    g, d = gaps(g_prog, g_ref, med_g, leaves), gaps(d_prog, d_ref, med_d, kept)
    diff = [float((program["trace1"][k].double() - weight_decay * p0[k]
                   - reference["grad0"][k].double()).norm())
            / max(g_ref[k], 1e-30) for k in leaves]
    losses = zip(program["losses"], reference["losses"])
    return {"loss_gap": max(abs(a - b) / abs(b) if math.isfinite(a)
                            else math.inf for a, b in losses),
            "grad_diff_median": float(np.median(diff)),
            "grad_gap_median": float(np.median(g)),
            "change_gap_median": float(np.median(d)),
            "grad_gap_worst": max(g), "change_gap_worst": max(d),
            "leaves_left_out": len(leaves) - len(kept)}

"""Quantization-aware training (QAT) for the int8 serving path.

The port of `geoestimation_tpu/models/qat.py`. PTQ (`models/quant.py`) is
the default; QAT fine-tunes the network THROUGH the serving quantizer so the
weights move to int8-robust minima, then exports a standard checkpoint every
CLI consumes.

  * It works on the BN-folded float32 network (`fold_variables`), the graph
    the int8 path quantizes; the stem carries the ImageNet fold and takes
    (pixel - 128) inputs, so the fake-quant grid is the serving stem's
    integer grid.
  * Weights: per-output-channel symmetric fake-quant with the
    straight-through estimator (`fake_quant_weight`), the grid of
    `quant._quant_weight`, its scale recomputed from the live weights each
    step without a gradient.
  * Activations: per-tensor fake-quant at the serving requant sites
    (`quant.site_names`: stem, m1/m2/out per block, the stage-entry conv3's
    signed `_y3`) with the calibrated scales, static during QAT
    (`fake_quant_act`).
  * Export: `unfold_to_variables` writes the fine-tuned folded weights into
    the port's state dict with IDENTITY BatchNorms (weight 1, mean 0,
    var 1 - eps, bias = the folded bias), in the JAX package's float32
    expressions and order, so the export equals the JAX package's export
    carried by `convert.from_jax_variables` bit for bit and both give the
    same `quant.weights_hash`.

The folded network (`fold_variables`) is {"stem": (kernel, bias),
"blocks": [(name, stride, {conv: (kernel, bias)})], "heads": {"fused_head":
{"kernel", "bias"}}} (ISN: {"scene_head", "scene_geo_heads"}), the convs
laid out as `quant._oihw` does (OIHW kernels, (C, 1, 1) biases) and the head
kernels (in, out). `folded_leaves` lists its tensors under the JAX package's
pytree paths; they are what QAT and distillation (`models/tta_distill.py`)
train, in place, with `train.optim.Optimizer`.

The forwards compute in float32 with TF32 off on CUDA
(`eval.engine.resolve_device`): the fake-quant grid decides roundings on
float32 values. They run on cuDNN through autograd and launch none of the
hand-written kernels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ingest.decode import IMAGENET_MEAN, IMAGENET_STD
from ..ingest.pipeline import augment, crop_draws, step_generator
from .isn import route_rows
from .quant import (_QMAX, _folded_blocks, _folded_conv, _oihw, _quant_weight,
                    _stem_fold, folded_trunk, round_like_serving,
                    weight_qmax)
from .resnet import BN_EPSILON, STAGE_SIZES


def rounded_pad_val():
    """The stem's border value, "pixel == dataset mean" rounded to the int8
    grid (the serving paths' `stem_pad_val`), as float32 (3,)."""
    mean255 = np.asarray(IMAGENET_MEAN, np.float32) * 255.0
    return np.clip(np.round(mean255 - 128.0), -128, 127).astype(np.float32)


def _f32(v, device):
    """A float32 scalar on `device`: dividing a CUDA tensor by a Python
    number multiplies by its reciprocal, which rounds otherwise than the
    division the JAX package does."""
    return torch.as_tensor(v, dtype=torch.float32, device=device)


# -- fake-quant primitives (STE) ----------------------------------------------

def fake_quant_weight(k):
    """Per-output-channel symmetric int8 fake-quant of a conv weight `k`
    (output channel first, as torch lays it out), STE gradient: the grid of
    `quant._quant_weight` (scale = absmax / weight_qmax(), zero channels
    scale 1), the scale computed without a gradient."""
    wq = _f32(weight_qmax(), k.device)
    with torch.no_grad():
        s = k.abs().amax(dim=tuple(range(1, k.dim())), keepdim=True) / wq
        s = torch.where(s == 0, torch.ones_like(s), s)
        q = torch.clamp(torch.round(k / s), -wq, wq) * s
    return k + (q - k).detach()


class _FakeQuantAct(torch.autograd.Function):
    """where(mask, x + (q - x), q) forward, grad * mask backward: the JAX
    package's `where(mask, x + stop_gradient(q - x), stop_gradient(q))`,
    saving only the mask for the backward."""

    @staticmethod
    def forward(ctx, x, q, mask):
        ctx.save_for_backward(mask)
        return torch.where(mask, x + (q - x), q)

    @staticmethod
    def backward(ctx, grad):
        (mask,) = ctx.saved_tensors
        return torch.where(mask, grad, torch.zeros_like(grad)), None, None


def fake_quant_act(x, scale, lo=0.0, upper_ste=False):
    """Per-tensor fake-quant at a serving requant site, STE gradient:
    clip(round_like_serving(x / s), lo, 127) * s. The gradient passes
    where (x / s) lies in [lo, 127]; with `upper_ste` it also passes above
    127 at the lo = 0 sites, and everywhere at the signed site (lo != 0)."""
    s = _f32(scale, x.device)
    with torch.no_grad():
        y = x / s
        q = torch.clamp(round_like_serving(y), lo, _QMAX) * s
        if upper_ste:
            mask = (y >= lo) if lo == 0.0 else torch.ones_like(
                y, dtype=torch.bool)
        else:
            mask = (y >= lo) & (y <= _QMAX)
    return _FakeQuantAct.apply(x, q, mask)


def teacher_student_kl(t_logits, s_logits):
    """Sum over heads of the batch-mean KL(teacher || student)."""
    kl = 0.0
    for t, s in zip(t_logits, s_logits):
        t, s = t.float(), s.float()
        p = torch.softmax(t, dim=-1)
        kl = kl + torch.mean(torch.sum(
            p * (torch.log_softmax(t, dim=-1) - torch.log_softmax(s, dim=-1)),
            dim=-1))
    return kl


# -- fold / unfold ------------------------------------------------------------

def fold_variables(state_dict, arch="resnet50", eps=BN_EPSILON,
                   device="cpu", requires_grad=False):
    """The port's state dict -> the folded float32 network on `device`:
    {"stem": (kernel, bias), "blocks": [(name, stride, {conv: (kernel,
    bias)})], "heads": {"fused_head": {"kernel", "bias"}}}, the convs laid
    out as `quant._oihw` does and the head kernels (in, out); an ISN
    checkpoint's heads are {"scene_head": ..., "scene_geo_heads": ...}.
    Every tensor is a leaf; `requires_grad` makes each trainable."""
    device = torch.device(device)
    wp, bpp, _ = _stem_fold(state_dict, eps)

    def linear(name):
        # copies: a trained leaf must not alias the caller's state dict
        return {"kernel": state_dict[f"{name}.weight"].detach().to(
                    device, torch.float32, copy=True).t(),
                "bias": state_dict[f"{name}.bias"].detach().to(
                    device, torch.float32, copy=True)}

    if "scene_head.weight" in state_dict:
        heads = {"scene_head": linear("scene_head"),
                 "scene_geo_heads": linear("scene_geo_heads")}
    else:
        heads = {"fused_head": linear("heads.fused_head")}
    folded = {"stem": _oihw(wp, bpp, device),
              "blocks": _folded_blocks(state_dict, arch, eps, device),
              "heads": heads}
    if requires_grad:
        for _, t in folded_leaves(folded):
            t.requires_grad_(True)
    return folded


def folded_leaves(folded):
    """[(path, tensor)] of the folded network, under the JAX package's
    pytree paths ("stem/kernel", "blocks/layer1_block0/conv1/bias",
    "heads/fused_head/kernel", ...)."""
    out = [("stem/kernel", folded["stem"][0]),
           ("stem/bias", folded["stem"][1])]
    for name, _, fb in folded["blocks"]:
        for cname, (k, b) in fb.items():
            out += [(f"blocks/{name}/{cname}/kernel", k),
                    (f"blocks/{name}/{cname}/bias", b)]
    for hname, head in folded["heads"].items():
        out += [(f"heads/{hname}/kernel", head["kernel"]),
                (f"heads/{hname}/bias", head["bias"])]
    return out


def snapshot(folded):
    """A detached copy of every leaf of `folded` (the optimizer updates the
    leaves in place, so a kept snapshot must not alias them)."""
    return [t.detach().clone() for _, t in folded_leaves(folded)]


@torch.no_grad()
def restore(folded, snap):
    """Copy a `snapshot` back into the leaves of `folded`."""
    for (_, t), s in zip(folded_leaves(folded), snap):
        t.copy_(s)


def _hwio(kernel):
    """An OIHW folded kernel -> contiguous HWIO float32 numpy (exact)."""
    return np.ascontiguousarray(
        kernel.detach().to("cpu", torch.float32).numpy().transpose(2, 3, 1, 0))


def _np1(t):
    return t.detach().to("cpu", torch.float32).reshape(-1).numpy()


def unfold_to_variables(folded, state_dict, arch="resnet50", eps=BN_EPSILON):
    """Folded network -> the port's state dict with identity BatchNorms.

    Every conv takes the folded kernel; every BatchNorm becomes the identity
    under refolding (weight 1, running_mean 0, running_var 1 - eps, bias the
    folded bias); the stem's ImageNet fold is inverted (kernel * std255, the
    bias shift removed), since the bf16 path normalizes in ingest; the heads
    are carried. `state_dict` supplies the keys the result keeps (e.g.
    num_batches_tracked). The JAX package's float32 numpy expressions, in
    its order."""
    sd = {k: v.detach().cpu().clone() for k, v in state_dict.items()}

    def put(key, array):
        sd[key] = torch.from_numpy(np.array(array, np.float32))

    def conv(prefix, kernel):
        put(f"{prefix}.weight", _hwio(kernel).transpose(3, 2, 0, 1))

    def identity_bn(prefix, bias):
        c = bias.shape[0]
        put(f"{prefix}.weight", np.ones(c, np.float32))
        put(f"{prefix}.bias", np.asarray(bias, np.float32))
        put(f"{prefix}.running_mean", np.zeros(c, np.float32))
        put(f"{prefix}.running_var", np.full(c, 1.0 - eps, np.float32))

    mean255 = np.asarray(IMAGENET_MEAN, np.float32) * 255.0
    std255 = np.asarray(IMAGENET_STD, np.float32) * 255.0
    wp = _hwio(folded["stem"][0])
    bpp = _np1(folded["stem"][1])
    stem_k = wp * std255[None, None, :, None]
    stem_b = bpp - np.einsum("hwco,c->o", wp, 128.0 - mean255)
    put("backbone.conv1.weight", stem_k.transpose(3, 2, 0, 1))
    identity_bn("backbone.bn1", stem_b)

    names = {f"layer{s + 1}_block{b}": f"backbone.layer{s + 1}.{b}"
             for s, n in enumerate(STAGE_SIZES[arch]) for b in range(n)}
    for name, _, fb in folded["blocks"]:
        prefix = names[name]
        for cname, bn in (("conv1", "bn1"), ("conv2", "bn2"),
                          ("conv3", "bn3")):
            conv(f"{prefix}.{cname}", fb[cname][0])
            identity_bn(f"{prefix}.{bn}", _np1(fb[cname][1]))
        if "downsample" in fb:
            conv(f"{prefix}.downsample.0", fb["downsample"][0])
            identity_bn(f"{prefix}.downsample.1", _np1(fb["downsample"][1]))
    key = {"fused_head": "heads.fused_head"}
    for hname, head in folded["heads"].items():
        k = key.get(hname, hname)
        put(f"{k}.weight", head["kernel"].detach().cpu().float().numpy().T)
        put(f"{k}.bias", _np1(head["bias"]))
    return sd


def quantize_folded(folded, arch="resnet50"):
    """Folded network -> the `quant.quantize_model` qnet dict (int8 HWIO
    weights under the JAX block names), on the shared `quant._quant_weight`
    so the grids cannot diverge."""
    pad_val = rounded_pad_val().astype(np.int8)
    stem_q, stem_sw = _quant_weight(_hwio(folded["stem"][0]))
    blocks = {}
    for name, _, fb in folded["blocks"]:
        qb = {}
        for cname, (k, b) in fb.items():
            kq, sw = _quant_weight(_hwio(k))
            qb[cname] = (kq, sw, _np1(b))
        blocks[name] = qb

    def linear(h):
        return {"kernel": np.ascontiguousarray(
                    h["kernel"].detach().cpu().float().numpy()),
                "bias": _np1(h["bias"])}

    heads = {k: linear(h) for k, h in folded["heads"].items()}
    isn = "scene_geo_heads" in heads
    return {
        "arch": arch,
        "stage_sizes": STAGE_SIZES[arch],
        "stem": (stem_q, stem_sw, _np1(folded["stem"][1])),
        "stem_pad_val": pad_val,
        "blocks": blocks,
        "isn": isn,
        "heads": heads if isn else {"heads": heads},
    }


# -- the QAT forward ----------------------------------------------------------

def _heads(heads, feats, n_classes):
    """float32 heads on the pooled features; an ISN checkpoint's routed by
    its scene argmax (the scene head frozen: no gradient reaches it)."""
    if "scene_geo_heads" in heads:
        scene = heads["scene_head"]
        route = (feats.detach() @ scene["kernel"].detach()
                 + scene["bias"].detach()).argmax(-1)
        geo = heads["scene_geo_heads"]
        flat = feats @ geo["kernel"] + geo["bias"]
        logits = route_rows(flat.reshape(flat.shape[0],
                                         scene["bias"].shape[0], -1), route)
    else:
        head = heads["fused_head"]
        logits = feats @ head["kernel"] + head["bias"]
    if n_classes is None:
        return logits
    return list(torch.split(logits, tuple(n_classes), dim=-1))


def _stem_input(x, pad_val):
    """(B, H, W, 3) (pixel - 128) crops -> NCHW with 3 px of `pad_val`
    around them ("pixel == dataset mean")."""
    return F.pad((x - pad_val).permute(0, 3, 1, 2), (3, 3, 3, 3)) \
        + pad_val[:, None, None]


def build_qat_apply(arch, act_scales, n_classes=None, fake_quant=True,
                    taps=False, upper_ste=False):
    """Returns `apply(folded, x) -> [per-head float32 logits]` for x the
    (B, H, W, 3) float32 (pixel - 128) crops.

    `fake_quant=True` simulates `quant.build_int8_apply` value for value in
    float32: the stem's borders padded with the rounded dataset mean, every
    weight on its fake-quant grid, `fake_quant_act` at every requant site
    (`upper_ste` its gradient rule), the 3x3/s2 max pool padded with -inf,
    float32 heads (an ISN checkpoint's routed by the scene argmax, the
    scene head frozen). Differentiable end to end.

    `fake_quant=False` is the folded float32 forward of the original network
    (the teacher of `quant.autoselect_scales` and of the anchored QAT loss),
    padded with the exact dataset mean, under `torch.inference_mode`.

    `taps=True`: apply returns (logits, sat), sat mapping each site of
    `act_scales` to the share of its values above the clip ceiling
    (v / scale > 127), before the quantizer."""
    if not fake_quant:
        return _teacher_apply(act_scales, n_classes, taps)
    per_device = {}

    def constants(device):
        if device not in per_device:
            per_device[device] = (
                torch.from_numpy(rounded_pad_val()).to(device),
                {k: _f32(np.float32(v), device)
                 for k, v in act_scales.items()})
        return per_device[device]

    def apply(folded, x):
        pad_val, scales = constants(x.device)
        sat = {}

        def act(v, site, lo=0.0):
            if taps:
                sat[site] = (v.detach() / scales[site] > _QMAX).float().mean()
            return fake_quant_act(v, scales[site], lo=lo, upper_ste=upper_ste)

        def conv(v, kb, s=1, pad=0):
            return F.conv2d(v, fake_quant_weight(kb[0]), None, s, pad) + kb[1]

        y = act(conv(_stem_input(x, pad_val), folded["stem"], 2), "stem")
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        for name, stride, fb in folded["blocks"]:
            h = act(conv(y, fb["conv1"]), f"{name}_m1")
            h = act(conv(h, fb["conv2"], stride, 1), f"{name}_m2")
            h3 = conv(h, fb["conv3"])
            if "downsample" in fb:
                # entry block: conv3 requantizes standalone (signed)
                h3 = act(h3, f"{name}_y3", lo=-_QMAX)
                res = conv(y, fb["downsample"], stride)
            else:
                res = y
            y = act(h3 + res, f"{name}_out")
        logits = _heads(folded["heads"], y.mean(dim=(2, 3)), n_classes)
        return (logits, sat) if taps else logits

    return apply


def _teacher_apply(act_scales, n_classes, taps):
    """`build_qat_apply(..., fake_quant=False)`: the folded float32 forward,
    the stem's borders padded with the exact dataset mean, then the
    calibration traversal's trunk (`quant.folded_trunk`: relu at the lo=0
    requant sites, the stage-entry conv3 un-clipped) and float32 heads.
    `act_scales` is read only by `taps`."""

    @torch.inference_mode()
    def apply(folded, x):
        # the teacher pads with the exact (unquantized) dataset mean: the
        # original model's zero in the normalized domain
        pad_val = torch.tensor(np.asarray(IMAGENET_MEAN, np.float32) * 255.0
                               - 128.0, device=x.device)
        sat = {}
        site = None
        if taps:
            scales = {k: _f32(np.float32(v), x.device)
                      for k, v in act_scales.items()}

            def site(name, v):
                # post-relu at the lo=0 sites: the same share above 127
                sat[name] = (v / scales[name] > _QMAX).float().mean()

        y = _folded_conv(_stem_input(x, pad_val), folded["stem"], 2)
        if taps:
            site("stem", y)
        y = folded_trunk(torch.relu(y), folded["blocks"], site)
        logits = _heads(folded["heads"], y.mean(dim=(2, 3)), n_classes)
        return (logits, sat) if taps else logits

    return apply


# -- the training step --------------------------------------------------------

def backward_and_step(optimizer, loss, frozen=()):
    """loss.backward(), a zero gradient for every parameter the loss did not
    reach (the JAX package's gradient there: the frozen ISN scene head) and
    for the `frozen` ones, then the optimizer's update in place."""
    optimizer.zero_grad()
    loss.backward()
    for p in optimizer.params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    for p in frozen:
        p.grad = torch.zeros_like(p)
    optimizer.step()


def make_qat_train_step(apply_fn, optimizer, crop=224, label_smoothing=0.0,
                        crop_scale=None, anchor_weight=0.0,
                        teacher_apply=None, teacher_folded=None):
    """Returns `step(folded, images_u8, labels, seed, step_no, draws=None)
    -> metrics`, updating the leaves of `folded` in place through
    `optimizer` (a `train.optim.Optimizer` over `folded_leaves(folded)`).

    The crops are the checkpoint's training views: a random resized crop
    with `crop_scale` (None or (1, 1): a plain random crop) and flips, from
    `draws` or else `ingest.pipeline.crop_draws(step_generator(seed,
    step_no), ...)`, shifted to (pixel - 128). The loss is the summed
    multi-head cross-entropy, plus `anchor_weight` x KL(teacher ||
    student) against the frozen float32 teacher (`teacher_apply` =
    `build_qat_apply(..., fake_quant=False)` on `teacher_folded`).
    metrics: loss, loss_head{i}, and anchor_kl when anchored, detached."""
    from .classifier import multi_head_cross_entropy

    if anchor_weight and (teacher_apply is None or teacher_folded is None):
        raise ValueError("anchor_weight > 0 needs teacher_apply and "
                         "teacher_folded")

    def step(folded, images_u8, labels, seed, step_no, draws=None):
        if draws is None:
            b, h, w, _ = images_u8.shape
            draws = crop_draws(step_generator(seed, step_no), b, h, w, crop,
                               crop_scale)
        x = augment(images_u8, draws, crop, crop_scale).float() - 128.0
        if anchor_weight:
            with torch.no_grad():
                # out of inference mode: the KL saves its softmax
                t_logits = [t.clone()
                            for t in teacher_apply(teacher_folded, x)]
        logits = apply_fn(folded, x)
        total, per_head = multi_head_cross_entropy(
            logits, labels, label_smoothing=label_smoothing)
        anchor = None
        if anchor_weight:
            anchor = teacher_student_kl(t_logits, logits)
            total = total + anchor_weight * anchor
        backward_and_step(optimizer, total)
        metrics = {"loss": total.detach(),
                   **{f"loss_head{i}": l.detach()
                      for i, l in enumerate(per_head)}}
        if anchor is not None:
            metrics["anchor_kl"] = anchor.detach()
        return metrics

    return step

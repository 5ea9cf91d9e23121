"""Fast inference path: BN-folded bf16 ResNet with the fused bottleneck kernel.

The port of `build_fast_apply` in `geoestimation_tpu/models/fast_infer.py`.
From the classifier's state dict it builds `apply(images) -> [logits]`
where:

  * every conv's BatchNorm is folded into its weights (running statistics);
  * the stride-1 bottleneck blocks of the stages in PALLAS_STAGES (layer1
    and layer2) run through the hand-written CUDA kernel
    (`ops/fused_bottleneck.py`) when `use_pallas` is set;
  * with `use_pallas_s2` too, the stride-2 stage entries whose input width
    is a multiple of 8 (layer2.0 of ResNet50 at 224 px) run through the
    stride-2 kernel;
  * the stem, the other stage entries and the other stages run as
    channels-last bf16 convolutions;
  * the fused multi-head layer takes bf16 features and weights with float32
    accumulation.

Rounding follows the JAX fast path: outside the kernel every conv output is
bf16 and its bias is added in bf16; inside it, the kernel's own rounding
points. An ISN checkpoint's heads (`models/isn.py`) take the same bf16
features and weights, and each row is routed by its scene argmax.

Also here, as in the JAX module: the W-mirrored network (`mirror=True`),
mirror TTA (`build_mirror_tta_apply`: five crops through the network and its
mirror instead of ten crops) and feature-space TTA (`build_feature_tta_apply`
with `ftta_mirror_concat` and `ftta_windows`, the one copy of its geometry,
which the int8 path imports).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ingest.pipeline import make_crops, normalize
from ..ops.fused_bottleneck import fold_bn, fused_bottleneck, fused_bottleneck_s2
from ..utils.spans import span
from .isn import route_rows
from .resnet import BN_EPSILON, STAGE_SIZES

# Stages whose stride-1 blocks go through the fused kernel, with the JAX
# package's images-per-tile for each (only a batch-divisibility condition
# here).
PALLAS_STAGES = {0: 1, 1: 2}

_CL = torch.channels_last


def _fold(sd, conv, bn, eps):
    return fold_bn(sd[f"{conv}.weight"], sd[f"{bn}.weight"], sd[f"{bn}.bias"],
                   sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"], eps)


def _conv_weights(k, b, device):
    """Folded conv for the cuDNN path: OIHW bf16 channels-last, bf16 bias."""
    return (k.to(device, torch.bfloat16).contiguous(memory_format=_CL),
            b.to(device, torch.bfloat16)[:, None, None])


def _fold_block(sd, prefix, eps, fused, device, mirror=False):
    """One bottleneck's folded weights, in the form its path takes; with
    `mirror`, the 3x3's width taps flipped (the 1x1s have none)."""
    convs = [("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3")]
    if f"{prefix}.downsample.0.weight" in sd:
        convs.append(("downsample.0", "downsample.1"))
    folded = [_fold(sd, f"{prefix}.{c}", f"{prefix}.{b}", eps)
              for c, b in convs]
    if mirror:
        folded[1] = (folded[1][0].flip(3), folded[1][1])
    if not fused:
        return [_conv_weights(k, b, device) for k, b in folded]
    bf16 = torch.bfloat16
    (k1, b1), (k2, b2), (k3, b3) = folded[:3]
    args = [k1[:, :, 0, 0], b1, k2.permute(0, 2, 3, 1), b2, k3[:, :, 0, 0], b3]
    if len(folded) == 4:
        args += [folded[3][0][:, :, 0, 0], folded[3][1]]
    return [a.to(device, bf16 if i % 2 == 0 else torch.float32).contiguous()
            for i, a in enumerate(args)]


def _conv_bias(x, k, b, stride=1, padding=0):
    return F.conv2d(x, k, None, stride, padding) + b


def _conv_block(x, weights, stride, mirror=False):
    """Folded bottleneck as bf16 convolutions (any stride). With `mirror`,
    the W-mirrored block: a stride-2 3x3 pads its width (0, 1) and the
    stride-2 1x1 downsample (-1, 0), i.e. drops the first column; a
    stride-1 block is its own mirror given flipped taps."""
    (k1, b1), (k2, b2), (k3, b3) = weights[:3]
    xd = x
    y = torch.relu(_conv_bias(x, k1, b1))
    if mirror and stride == 2:
        y = torch.relu(_conv_bias(F.pad(y, (0, 1, 1, 1)), k2, b2, stride))
        xd = x[..., 1:]
    else:
        y = torch.relu(_conv_bias(y, k2, b2, stride, 1))
    y = _conv_bias(y, k3, b3)
    res = x if len(weights) == 3 else _conv_bias(xd, *weights[3], stride)
    return torch.relu(y + res)


def _kernel_block(x, weights, kernel):
    """A bottleneck through one of the fused kernels (NCHW channels-last in
    and out; the kernel sees the same bytes as NHWC)."""
    out = kernel(x.permute(0, 2, 3, 1).contiguous(), *weights)
    return out.permute(0, 3, 1, 2)


def head_weights(geo, scene=None, device="cuda"):
    """The heads' device form from (weight (out, in), bias) pairs: weights
    rounded to bf16 and held in float32 (products of bf16 values are exact
    there), float32 biases. `geo` is the fused head, or for an ISN
    checkpoint every scene's geo heads, with its `scene` head."""
    def linear(w, b):
        return (w.to(torch.bfloat16).to(device, torch.float32),
                b.to(device, torch.float32))

    heads = {"geo": linear(*geo)}
    if scene is not None:
        heads["scene"] = linear(*scene)
    return heads


def head_forward(feats, heads, n_classes=None):
    """float32 pooled features (B, F) -> per-head logits: the features
    rounded to bf16, float32 sums; an ISN head routes each row to its scene
    argmax's geo heads. Split per partitioning when `n_classes` is given."""
    feats = feats.to(torch.bfloat16).float()
    logits = F.linear(feats, *heads["geo"])
    if "scene" in heads:
        route = F.linear(feats, *heads["scene"]).argmax(-1)
        logits = route_rows(logits.reshape(logits.shape[0],
                                           heads["scene"][1].shape[0], -1),
                            route)
    if n_classes is None:
        return logits
    return list(torch.split(logits, tuple(n_classes), dim=-1))


def build_fast_apply(state_dict, arch="resnet50", n_classes=None,
                     use_pallas=True, use_pallas_s2=False, pallas_stages=None,
                     device="cuda", eps=BN_EPSILON, mirror=False):
    """Returns `apply(images) -> [per-head float32 logits]` on `device`.

    `images` are already normalized, NHWC (B, H, W, 3). If `n_classes` is
    given, the fused head output is split per partitioning like the
    classifier's. An ISN checkpoint (`scene_head` in the state dict) routes
    each row to the geo heads of its scene's argmax, as
    `models.isn.ISNClassifier` does; the layers route as for the base
    classifier (`use_pallas` applies to both, as in the JAX package).

    `pallas_stages`: {stage_index: images_per_tile} overriding
    PALLAS_STAGES -- which stages' stride-1 blocks run the fused kernel
    (an empty dict: none). `use_pallas_s2` (with `use_pallas`) sends the
    stride-2 stage entries to `fused_bottleneck_s2`. Routing is decided per
    call on the activation's shape, with the JAX package's conditions: a
    stage's stride-1 blocks go to the kernel when the batch divides by the
    stage's images_per_tile (a TPU tile size, which means nothing else to
    the CUDA kernels), a stage entry when its input width is a multiple of
    8. No CLI sets `use_pallas_s2`, as in the JAX package.

    `mirror=True` builds the W-mirrored network: netM(x) equals
    flip_W(net(flip_W(x))) layer by layer, so after the global pool
    netM(crop) has the features of net(flip(crop)). The stem's and every
    3x3's width taps are flipped, and a layer of k taps, stride s and left
    width padding pl on a width W -> W' pads s*W' - W + k - s - pl on the
    left instead: the stem (2, 3), the max pool (0, 1) with -inf, a stride-2
    3x3 (0, 1), a stride-2 1x1 downsample (-1, 0) (the JAX package's
    figures, for even widths). Heights are untouched. The stride-2 kernel is
    not used (`use_pallas_s2` is ignored); the stride-1 blocks still take
    the fused kernel, with flipped taps.

    `apply.stage_fns` are [stem, layer1, ..., layer4] and
    `apply.head_logits` the pooled head, so that
    apply(x) == head_logits(stage_fns[-1](... stage_fns[0](x))) bit for bit;
    the stages take and give NCHW channels-last bf16 activations.
    """
    device = torch.device(device)
    stage_npi = PALLAS_STAGES if pallas_stages is None else pallas_stages
    sd = {k: v.detach().to("cpu", torch.float32)
          for k, v in state_dict.items() if v.is_floating_point()}
    stem_k, stem_b = _fold(sd, "backbone.conv1", "backbone.bn1", eps)
    stem = _conv_weights(stem_k.flip(3) if mirror else stem_k, stem_b, device)
    stages = []
    for stage, n_blocks in enumerate(STAGE_SIZES[arch]):
        blocks = []
        for b in range(n_blocks):
            prefix = f"backbone.layer{stage + 1}.{b}"
            stride = 2 if stage > 0 and b == 0 else 1
            fused = use_pallas and (
                (stride == 1 and stage in stage_npi)
                or (stride == 2 and use_pallas_s2 and not mirror))
            # the conv form too: a shape the kernel route refuses takes it
            blocks.append((
                _fold_block(sd, prefix, eps, False, device, mirror),
                _fold_block(sd, prefix, eps, True, device, mirror)
                if fused else None,
                stride, stage_npi.get(stage, 1) if stride == 1 else 1))
        stages.append(blocks)

    def linear(name):
        return sd[f"{name}.weight"], sd[f"{name}.bias"]

    heads = (head_weights(linear("scene_geo_heads"), linear("scene_head"),
                          device) if "scene_head.weight" in sd
             else head_weights(linear("heads.fused_head"), device=device))

    def stem_fn(images):
        with span("models.stem", device=True):
            x = images.to(torch.bfloat16).permute(0, 3, 1, 2)
            if mirror:
                # the mirrored width paddings: the stem's (2, 3), the pool's
                # (0, 1) with -inf, as reduce_window pads
                x = torch.relu(_conv_bias(F.pad(x, (2, 3, 3, 3)), *stem, 2))
                return F.max_pool2d(
                    F.pad(x, (0, 1, 1, 1), value=float("-inf")), 3, stride=2)
            x = torch.relu(_conv_bias(x, *stem, 2, 3))
            return F.max_pool2d(x, 3, stride=2, padding=1)

    def make_stage_fn(blocks):
        def stage_fn(x):
            rest = blocks
            conv, kernel, stride, _ = blocks[0]
            if stride == 2:
                # the stage entry's images_per_tile is 1: any batch divides
                if kernel is not None and x.shape[3] % 8 == 0:
                    x = _kernel_block(x, kernel, fused_bottleneck_s2)
                else:
                    x = _conv_block(x, conv, 2, mirror)
                rest = blocks[1:]
            if rest and rest[0][1] is not None \
                    and x.shape[0] % rest[0][3] == 0:
                for _, kernel, _, _ in rest:
                    x = _kernel_block(x, kernel, fused_bottleneck)
            else:
                for conv, _, stride, _ in rest:
                    x = _conv_block(x, conv, stride)
            return x
        return stage_fn

    stage_fns = [stem_fn] + [make_stage_fn(blocks) for blocks in stages]

    def head_logits(x):
        return head_forward(x.mean(dim=(2, 3), dtype=torch.float32), heads,
                            n_classes)

    def apply(images):
        x = images
        for fn in stage_fns:
            x = fn(x)
        return head_logits(x)

    apply.stage_fns = stage_fns
    apply.head_logits = head_logits
    return apply


# -- feature-space TTA ----------------------------------------------------------

def ftta_mirror_concat(base, n_crops):
    """The trunk's input for feature-space TTA: the NHWC base batch, and for
    n_crops=10 its horizontal mirror appended on the batch axis (the
    flipped crops' windows are the same-offset windows of the mirror's
    trunk output: the five-crop offsets are mirror-closed). Shared by the
    bf16 and int8 feature-TTA paths: one geometry."""
    if n_crops == 10:
        return torch.cat([base, base.flip(2)], dim=0)
    return base


def ftta_windows(feats, b, s, crop, n_crops, level):
    """The crop-aligned windows of a trunk's NHWC feature map, folded into
    the batch: (b or 2b, g, g, C) -> (b * n_crops, w, w, C), contiguous.

    `feats` is the trunk's output on `ftta_mirror_concat`'s batch, at
    feature stride s // g. Raises unless the pixel crop grid lands exactly
    on the feature grid (crop and s - crop aligned to twice the stride).
    Window order: the five corner/center offsets, the unflipped five first,
    each image's windows adjacent (the JAX package's order)."""
    g = feats.shape[1]
    stride = s // g
    if crop % stride or (s - crop) % (2 * stride):
        raise ValueError(
            f"feature TTA needs crop {crop} and base {s} aligned to "
            f"2x the layer{level} stride ({stride})")
    w = crop // stride
    m = g - w
    offs = [(0, 0), (0, m), (m, 0), (m, m), (m // 2, m // 2)]
    u = feats[:b]
    windows = [u[:, r:r + w, c:c + w] for r, c in offs]
    if n_crops == 10:
        f = feats[b:]
        windows += [f[:, r:r + w, c:c + w] for r, c in offs]
    xc = torch.stack(windows, dim=1)
    return xc.reshape((b * n_crops,) + tuple(xc.shape[2:]))


def check_feature_tta(n_crops, level, n_stages, what="feature TTA"):
    """The JAX package's refusals of a feature-TTA configuration (`what`
    names it as the JAX message does)."""
    if n_crops not in (5, 10):
        raise ValueError(f"{what} n_crops must be 5 or 10")
    if not 1 <= level <= n_stages - 1:
        raise ValueError(
            f"{what} level must be in [1, {n_stages - 1}] (got {level})")


def check_square(base):
    """(B, S) of a square NHWC base batch; raises for another shape."""
    b, s, s2, _ = base.shape
    if s != s2:
        raise ValueError("feature TTA expects square base images")
    return b, s


def build_feature_tta_apply(state_dict, arch="resnet50", n_classes=None,
                            use_pallas=False, crop=224, n_crops=10,
                            eps=BN_EPSILON, level=3, device="cuda"):
    """Feature-space TTA in bf16: `apply(base_norm) -> logits (B * n_crops,
    C)` for the normalized square NHWC base images (B, S, S, 3), not crops.

    The stem and layer1..layer{level} run once on the base (and once on its
    mirror for n_crops=10); the crop-aligned windows of that stage's feature
    map then run the remaining stages and the head. At level 3 only layer4
    runs per crop. Approximate at crop borders by design (the features see
    real neighbours, not a crop's padding); the int8 twin is
    `quant.build_int8_apply(feature_tta=...)`."""
    inner = build_fast_apply(state_dict, arch, n_classes=n_classes,
                             use_pallas=use_pallas, device=device, eps=eps)
    check_feature_tta(n_crops, level, len(inner.stage_fns) - 1)
    trunk = inner.stage_fns[:1 + level]
    rest_stages = inner.stage_fns[1 + level:]

    def apply(base_norm):
        b, s = check_square(base_norm)
        x = ftta_mirror_concat(base_norm, n_crops)
        for fn in trunk:
            x = fn(x)
        xc = ftta_windows(x.permute(0, 2, 3, 1), b, s, crop, n_crops, level)
        xc = xc.permute(0, 3, 1, 2)
        for fn in rest_stages:
            xc = fn(xc)
        return inner.head_logits(xc)

    return apply


def build_mirror_tta_apply(state_dict, arch="resnet50", n_classes=None,
                           use_pallas=True, pallas_stages=None, crop=224,
                           n_crops=10, device="cuda"):
    """Flip-free ten-crop TTA: `apply(base_u8) -> [per-head logits]`, each
    (B * n_crops, C) in the (B, crops) order `mean_tta_logits` expects.

    Ten-crop is five crops and their horizontal flips; after the global pool
    net(flip(c)) has the features of netM(c), the mirrored network
    (`build_fast_apply(mirror=True)`), so the five unflipped crops run
    through net and netM: the same math with half the crops made.
    n_crops=5 or 1 skip the mirrored pass (plain five or center crop)."""
    kw = dict(n_classes=n_classes, use_pallas=use_pallas,
              pallas_stages=pallas_stages, device=device)
    net = build_fast_apply(state_dict, arch, **kw)
    net_m = (build_fast_apply(state_dict, arch, mirror=True, **kw)
             if n_crops == 10 else None)

    def apply(images_u8):
        b = images_u8.shape[0]
        crops = make_crops(normalize(images_u8),
                           5 if n_crops == 10 else n_crops, crop)
        crops = crops.reshape((-1,) + tuple(crops.shape[-3:]))
        la = net(crops)
        if n_crops != 10:
            return la
        lm = net_m(crops)
        single = not isinstance(la, (list, tuple))
        if single:
            la, lm = [la], [lm]
        out = [torch.cat([a.reshape(b, 5, -1), m.reshape(b, 5, -1)],
                         dim=1).reshape(b * 10, -1)
               for a, m in zip(la, lm)]
        return out[0] if single else out

    return apply

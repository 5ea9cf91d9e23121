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
points. Not ported yet: the mirrored network, feature TTA and ISN heads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.fused_bottleneck import fold_bn, fused_bottleneck, fused_bottleneck_s2
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


def _fold_block(sd, prefix, eps, fused, device):
    """One bottleneck's folded weights, in the form its path takes."""
    convs = [("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3")]
    if f"{prefix}.downsample.0.weight" in sd:
        convs.append(("downsample.0", "downsample.1"))
    folded = [_fold(sd, f"{prefix}.{c}", f"{prefix}.{b}", eps)
              for c, b in convs]
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


def _conv_block(x, weights, stride):
    """Folded bottleneck as bf16 convolutions (any stride)."""
    (k1, b1), (k2, b2), (k3, b3) = weights[:3]
    y = torch.relu(_conv_bias(x, k1, b1))
    y = torch.relu(_conv_bias(y, k2, b2, stride, 1))
    y = _conv_bias(y, k3, b3)
    res = x if len(weights) == 3 else _conv_bias(x, *weights[3], stride)
    return torch.relu(y + res)


def _kernel_block(x, weights, kernel):
    """A bottleneck through one of the fused kernels (NCHW channels-last in
    and out; the kernel sees the same bytes as NHWC)."""
    out = kernel(x.permute(0, 2, 3, 1).contiguous(), *weights)
    return out.permute(0, 3, 1, 2)


def build_fast_apply(state_dict, arch="resnet50", n_classes=None,
                     use_pallas=True, use_pallas_s2=False, pallas_stages=None,
                     device="cuda", eps=BN_EPSILON):
    """Returns `apply(images) -> [per-head float32 logits]` on `device`.

    `images` are already normalized, NHWC (B, H, W, 3). If `n_classes` is
    given, the fused head output is split per partitioning like the
    classifier's.

    `pallas_stages`: {stage_index: images_per_tile} overriding
    PALLAS_STAGES -- which stages' stride-1 blocks run the fused kernel
    (an empty dict: none). `use_pallas_s2` (with `use_pallas`) sends the
    stride-2 stage entries to `fused_bottleneck_s2`. Routing is decided per
    call on the activation's shape, with the JAX package's conditions: a
    stage's stride-1 blocks go to the kernel when the batch divides by the
    stage's images_per_tile (a TPU tile size, which means nothing else to
    the CUDA kernels), a stage entry when its input width is a multiple of
    8. No CLI sets `use_pallas_s2`, as in the JAX package.

    `apply.stage_fns` are [stem, layer1, ..., layer4] and
    `apply.head_logits` the pooled head, so that
    apply(x) == head_logits(stage_fns[-1](... stage_fns[0](x))) bit for bit;
    the stages take and give NCHW channels-last bf16 activations.
    """
    device = torch.device(device)
    stage_npi = PALLAS_STAGES if pallas_stages is None else pallas_stages
    sd = {k: v.detach().to("cpu", torch.float32)
          for k, v in state_dict.items() if v.is_floating_point()}
    if any(k.startswith("scene") for k in sd):
        raise NotImplementedError(
            "ISN checkpoints are not ported yet (ROADMAP.md Queue 1, 'ISN')")
    stem = _conv_weights(*_fold(sd, "backbone.conv1", "backbone.bn1", eps),
                         device)
    stages = []
    for stage, n_blocks in enumerate(STAGE_SIZES[arch]):
        blocks = []
        for b in range(n_blocks):
            prefix = f"backbone.layer{stage + 1}.{b}"
            stride = 2 if stage > 0 and b == 0 else 1
            fused = use_pallas and ((stride == 1 and stage in stage_npi)
                                    or (stride == 2 and use_pallas_s2))
            # the conv form too: a shape the kernel route refuses takes it
            blocks.append((
                _fold_block(sd, prefix, eps, False, device),
                _fold_block(sd, prefix, eps, True, device) if fused else None,
                stride, stage_npi.get(stage, 1) if stride == 1 else 1))
        stages.append(blocks)
    head_w = sd["heads.fused_head.weight"].to(torch.bfloat16).to(
        device, torch.float32)
    head_b = sd["heads.fused_head.bias"].to(device)

    def stem_fn(images):
        x = images.to(torch.bfloat16).permute(0, 3, 1, 2)
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
                    x = _conv_block(x, conv, 2)
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
        feats = x.mean(dim=(2, 3), dtype=torch.float32)
        # bf16 features and weights, products exact in float32, f32 sums
        logits = F.linear(feats.to(torch.bfloat16).float(), head_w, head_b)
        if n_classes is None:
            return logits
        return list(torch.split(logits, tuple(n_classes), dim=-1))

    def apply(images):
        x = images
        for fn in stage_fns:
            x = fn(x)
        return head_logits(x)

    apply.stage_fns = stage_fns
    apply.head_logits = head_logits
    return apply

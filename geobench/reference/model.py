"""The classifier in float32: a torchvision-layout ResNet trunk (He et al.
2016, bottleneck v1.5: the stride on the 3x3), BatchNorm in eval mode from
its running statistics, global average pool, one fused linear head over
the three partitionings. NCHW, `F.conv2d`, TF32 off.

`quant(x, kind)`, where given, rounds every convolution's and the head's
input (`kind="act"`) and weight (`kind="weight"`) to a lower precision: the
control of `quant.py`."""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
STAGE_SIZES = {"resnet14": (1, 1, 1, 1), "resnet50": (3, 4, 6, 3),
               "resnet101": (3, 4, 23, 3)}
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def no_tf32():
    """float32 means float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def ten_crops(images_u8, crop=224):
    """uint8 (B, S, S, 3) -> normalized float32 NCHW (B * 10, 3, crop,
    crop): the four corners and the center, then the same five mirrored
    left to right (torchvision's TenCrop order), crops of an image
    adjacent."""
    x = images_u8.float().permute(0, 3, 1, 2)
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1) * 255
    std = torch.tensor(STD, device=x.device).view(1, 3, 1, 1) * 255
    x = (x - mean) / std
    s = x.shape[-1]
    c0 = (s - crop) // 2
    five = [x[..., :crop, :crop], x[..., :crop, s - crop:],
            x[..., s - crop:, :crop], x[..., s - crop:, s - crop:],
            x[..., c0:c0 + crop, c0:c0 + crop]]
    crops = torch.stack(five + [c.flip(-1) for c in five], dim=1)
    return crops.reshape(-1, 3, crop, crop)


def _bn(x, sd, name):
    scale = sd[f"{name}.weight"] / torch.sqrt(sd[f"{name}.running_var"]
                                              + BN_EPS)
    shift = sd[f"{name}.bias"] - sd[f"{name}.running_mean"] * scale
    return x * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)


def _conv(x, sd, name, quant, stride=1, padding=0):
    w = sd[f"{name}.weight"]
    if quant is not None:
        x, w = quant(x, "act"), quant(w, "weight")
    return F.conv2d(x, w, None, stride, padding)


def features(x, sd, arch, quant=None):
    """(N, 3, H, W) float32 -> (N, 2048) pooled features."""
    p = "backbone"
    x = torch.relu(_bn(_conv(x, sd, f"{p}.conv1", quant, 2, 3), sd,
                       f"{p}.bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage, n_blocks in enumerate(STAGE_SIZES[arch]):
        for b in range(n_blocks):
            q = f"{p}.layer{stage + 1}.{b}"
            s = 2 if stage > 0 and b == 0 else 1
            y = torch.relu(_bn(_conv(x, sd, f"{q}.conv1", quant), sd,
                               f"{q}.bn1"))
            y = torch.relu(_bn(_conv(y, sd, f"{q}.conv2", quant, s, 1), sd,
                               f"{q}.bn2"))
            y = _bn(_conv(y, sd, f"{q}.conv3", quant), sd, f"{q}.bn3")
            if f"{q}.downsample.0.weight" in sd:
                x = _bn(_conv(x, sd, f"{q}.downsample.0", quant, s), sd,
                        f"{q}.downsample.1")
            x = torch.relu(y + x)
    return x.mean(dim=(2, 3))


def logits(feats, sd, quant=None):
    """(N, 2048) -> (N, sum of the class counts) through the fused head."""
    w, b = sd["heads.fused_head.weight"], sd["heads.fused_head.bias"]
    if quant is not None:
        feats, w = quant(feats, "act"), quant(w, "weight")
    return F.linear(feats, w, b)


@torch.no_grad()
def crop_logits(images_u8, sd, arch, quant=None, crop=224, block=32):
    """uint8 (B, S, S, 3) on the device -> (B * 10, classes) float32
    logits, `block` images at a time."""
    out = []
    for i in range(0, images_u8.shape[0], block):
        x = ten_crops(images_u8[i:i + block], crop)
        out.append(logits(features(x, sd, arch, quant), sd, quant))
    return torch.cat(out)

"""ResNet backbones in PyTorch, for inference.

The port of `geoestimation_tpu/models/resnet.py`. Children are named after
torchvision (`conv1`, `bn1`, `layer1.0.conv1`, `layer1.0.downsample.0`, ...),
so the state dict has the reference checkpoint's own keys. Bottlenecks are
v1.5 (stride on the 3x3); the stem is a 7x7/2 conv with pad 3, then a 3x3/2
max-pool with pad 1.

Public tensors are NHWC, as in the JAX package; inside, activations are NCHW
views in channels-last memory, the same bytes. Parameters and BatchNorm
statistics stay float32 and the compute dtype is a module attribute
(bfloat16 or float32), with the JAX model's rounding: convolutions in the
compute dtype; BatchNorm from running statistics in float32, cast back; the
global pool summed in float32 and rounded to the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# Canonical stage sizes -- the single source for anything that walks block
# names (fast inference path, weights bridge).
STAGE_SIZES: dict = {
    "resnet14": (1, 1, 1, 1),
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}

FEATURE_DIM = 2048
BN_EPSILON = 1e-5


def batch_norm(x, bn: nn.BatchNorm2d):
    """Inference BatchNorm as the JAX model computes it: float32 from the
    running statistics, ((x - mean) * (rsqrt(var + eps) * scale)) + bias,
    cast back to x's dtype."""
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    y = (x.float() - bn.running_mean[:, None, None]) * mul[:, None, None]
    return (y + bn.bias[:, None, None]).to(x.dtype)


def conv(x, layer: nn.Conv2d):
    """`layer`'s convolution in x's dtype."""
    return F.conv2d(x, layer.weight.to(x.dtype), None, layer.stride,
                    layer.padding)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(expand 4x) residual block."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=BN_EPSILON)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=BN_EPSILON)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out, eps=BN_EPSILON)
        self.downsample = None
        if inplanes != out or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, out, 1, stride=stride, bias=False),
                nn.BatchNorm2d(out, eps=BN_EPSILON))

    def forward(self, x):
        y = torch.relu(batch_norm(conv(x, self.conv1), self.bn1))
        y = torch.relu(batch_norm(conv(y, self.conv2), self.bn2))
        y = batch_norm(conv(y, self.conv3), self.bn3)
        res = x
        if self.downsample is not None:
            res = batch_norm(conv(x, self.downsample[0]), self.downsample[1])
        return torch.relu(y + res)


class ResNet(nn.Module):
    """ResNet feature extractor: NHWC images -> (B, 2048) float32 features."""

    def __init__(self, stage_sizes, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=BN_EPSILON)
        inplanes = 64
        for stage, n_blocks in enumerate(stage_sizes):
            planes = 64 * 2 ** stage
            blocks = []
            for b in range(n_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                blocks.append(Bottleneck(inplanes, planes, stride))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)

    def forward(self, images):
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        x = torch.relu(batch_norm(conv(x, self.conv1), self.bn1))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        # global average pool: float32 sum, rounded to the compute dtype
        feats = x.mean(dim=(2, 3), dtype=torch.float32)
        return feats.to(self.dtype).float()


def build_backbone(arch: str, dtype=torch.bfloat16) -> ResNet:
    if arch not in STAGE_SIZES:
        raise ValueError(f"unknown arch {arch!r}; have {sorted(STAGE_SIZES)}")
    return ResNet(STAGE_SIZES[arch], dtype=dtype)

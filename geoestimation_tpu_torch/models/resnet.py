"""ResNet backbones in PyTorch, for inference and training.

The port of `geoestimation_tpu/models/resnet.py`. Children are named after
torchvision (`conv1`, `bn1`, `layer1.0.conv1`, `layer1.0.downsample.0`, ...),
so the state dict has the reference checkpoint's own keys. Bottlenecks are
v1.5 (stride on the 3x3); the stem is a 7x7/2 conv with pad 3, then a 3x3/2
max-pool with pad 1.

Public tensors are NHWC, as in the JAX package; inside, activations are NCHW
views in channels-last memory, the same bytes. Parameters and BatchNorm
statistics stay float32 and the compute dtype is a module attribute
(bfloat16 or float32), with the JAX model's rounding: convolutions in the
compute dtype (float32 weights cast per forward); BatchNorm in float32, cast
back; the global pool summed in float32 and rounded to the compute dtype.

`forward(images, train=True)` is flax's train mode (`nn.BatchNorm`,
momentum 0.9): each BatchNorm normalizes with its batch's float32 mean and
biased "fast" variance E[x^2] - E[x]^2 (clipped at 0), and the running
statistics become 0.9 * old + 0.1 * batch, once per forward, after it. Each
train-mode BatchNorm runs with the relu or residual add after it as one
autograd Function (`ops/bn_train.py`: four CUDA kernels on the card, their
plain version on the CPU). In several processes the batch is the global
one, as under the JAX package's GSPMD: the statistics are summed over the
ranks by an all-reduce (`parallel/multihost.py`'s device group), and their
backward's sums too, so the running statistics agree on every rank without
a broadcast. With `remat`, each bottleneck block is recomputed on the
backward pass (`torch.utils.checkpoint`, flax's `nn.remat(Bottleneck)`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.bn_train import bn_train

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
BN_MOMENTUM = 0.9


def batch_norm(x, bn: nn.BatchNorm2d):
    """Inference BatchNorm as the JAX model computes it: float32 from the
    running statistics, ((x - mean) * (rsqrt(var + eps) * scale)) + bias,
    cast back to x's dtype."""
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    y = (x.float() - bn.running_mean[:, None, None]) * mul[:, None, None]
    return (y + bn.bias[:, None, None]).to(x.dtype)


def batch_norm_train(x, bn: nn.BatchNorm2d, relu=False, residual=None):
    """Train-mode BatchNorm as flax computes it, then relu where `relu`, or
    relu(y + residual) where a residual is given: statistics of x's batch
    in float32, the variance E[x^2] - E[x]^2 clipped at 0 (biased), then
    ((x - mean) * (rsqrt(var + eps) * scale)) + bias in float32, cast back
    to x's dtype, the residual added in that dtype. Returns (out, mean,
    var); the running statistics are the caller's to update
    (`update_running_stats`).

    The statistics are the float32 per-channel sums of x and x^2 over the
    element count. With a device group of several ranks they are the
    global batch's: the sums and the count are summed over the ranks
    (`multihost.sum_over_ranks`), and so are the backward's per-channel
    sums (`multihost.sum_bn_grads`), SyncBatchNorm's pattern
    (`ops.bn_train.bn_train`)."""
    return bn_train(x, bn.weight, bn.bias, bn.eps, relu=relu,
                    residual=residual)


def train_norms(arch: str, batch: int, crop: int) -> list:
    """[(name, (N, C, H, W), form)] of each train-mode BatchNorm of `arch`
    at `batch` square images of `crop` (even) px, in the forward's order;
    form "relu", "residual" (relu(y + residual)) or "plain"."""
    h = crop // 2
    out = [("bn1", (batch, 64, h, h), "relu")]
    h = (h - 1) // 2 + 1                       # the 3x3/2 max-pool, pad 1
    inplanes = 64
    for stage, n_blocks in enumerate(STAGE_SIZES[arch]):
        planes = 64 * 2 ** stage
        for b in range(n_blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            ho = (h - 1) // stride + 1
            name, wide = f"layer{stage + 1}.{b}", planes * Bottleneck.expansion
            out += [(f"{name}.bn1", (batch, planes, h, h), "relu"),
                    (f"{name}.bn2", (batch, planes, ho, ho), "relu")]
            if inplanes != wide or stride != 1:
                out.append((f"{name}.downsample.1", (batch, wide, ho, ho),
                            "plain"))
            out.append((f"{name}.bn3", (batch, wide, ho, ho), "residual"))
            inplanes, h = wide, ho
    return out


@torch.no_grad()
def update_running_stats(bns, stats, momentum=BN_MOMENTUM):
    """running = momentum * running + (1 - momentum) * batch, for each
    BatchNorm of `bns` and its (mean, var) in the flat list `stats`: over
    all of them at once (`torch._foreach_*`, a few launches on a card),
    each product and the sum rounded in float32 as one BatchNorm's would
    be."""
    running = [bn.running_mean for bn in bns] + [bn.running_var for bn in bns]
    batch = list(stats[0::2]) + list(stats[1::2])
    torch._foreach_mul_(running, momentum)
    torch._foreach_add_(running, torch._foreach_mul(batch, 1 - momentum))


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

    def norms(self):
        """The block's BatchNorms in the order `forward_train` returns their
        statistics."""
        out = [self.bn1, self.bn2, self.bn3]
        return out + ([self.downsample[1]] if self.downsample is not None
                      else [])

    def forward(self, x):
        y = torch.relu(batch_norm(conv(x, self.conv1), self.bn1))
        y = torch.relu(batch_norm(conv(y, self.conv2), self.bn2))
        y = batch_norm(conv(y, self.conv3), self.bn3)
        res = x
        if self.downsample is not None:
            res = batch_norm(conv(x, self.downsample[0]), self.downsample[1])
        return torch.relu(y + res)

    def forward_train(self, x):
        """Train mode: (y, mean, var, mean, var, ...), the batch statistics
        of `norms()` in order."""
        y, *s1 = batch_norm_train(conv(x, self.conv1), self.bn1, relu=True)
        y, *s2 = batch_norm_train(conv(y, self.conv2), self.bn2, relu=True)
        res, sd = x, []
        if self.downsample is not None:
            res, *sd = batch_norm_train(conv(x, self.downsample[0]),
                                        self.downsample[1])
        y, *s3 = batch_norm_train(conv(y, self.conv3), self.bn3, relu=True,
                                  residual=res)
        return (y, *s1, *s2, *s3, *sd)


class ResNet(nn.Module):
    """ResNet feature extractor: NHWC images -> (B, 2048) float32 features."""

    def __init__(self, stage_sizes, dtype=torch.bfloat16, remat=False):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
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

    def blocks(self):
        return [b for stage in range(self.n_stages)
                for b in getattr(self, f"layer{stage + 1}")]

    def forward(self, images, train=False):
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        if train:
            x = self._trunk_train(x)
        else:
            x = torch.relu(batch_norm(conv(x, self.conv1), self.bn1))
            x = F.max_pool2d(x, 3, stride=2, padding=1)
            for stage in range(self.n_stages):
                x = getattr(self, f"layer{stage + 1}")(x)
        # global average pool: float32 sum, rounded to the compute dtype
        feats = x.mean(dim=(2, 3), dtype=torch.float32)
        return feats.to(self.dtype).float()

    def _trunk_train(self, x):
        x, *stats = batch_norm_train(conv(x, self.conv1), self.bn1, relu=True)
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        bns = [self.bn1]
        for block in self.blocks():
            if self.remat:
                x, *s = checkpoint(block.forward_train, x, use_reentrant=False)
            else:
                x, *s = block.forward_train(x)
            stats += s
            bns += block.norms()
        # after the forward, so that a recomputed block updates nothing
        update_running_stats(bns, stats)
        return x


def build_backbone(arch: str, dtype=torch.bfloat16, remat=False) -> ResNet:
    if arch not in STAGE_SIZES:
        raise ValueError(f"unknown arch {arch!r}; have {sorted(STAGE_SIZES)}")
    return ResNet(STAGE_SIZES[arch], dtype=dtype, remat=remat)

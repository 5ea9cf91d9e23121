"""Device image pipeline for evaluation: normalization and crops, in torch.

The port of the eval half of `geoestimation_tpu/ingest/pipeline.py`. The
host hands the device a uint8 (B, base, base, 3) tensor; normalization runs
first, in float32, cast last, then the crops are slices and flips of the
normalized image. Tensors stay NHWC.

Crop semantics: ten-crop = 4 corners + center of the base image at `crop`
resolution, plus the horizontal flips of all five (torchvision's TenCrop).
"""

from __future__ import annotations

import torch

from .decode import IMAGENET_MEAN, IMAGENET_STD


def normalize(images, dtype=torch.bfloat16):
    """uint8 (..., H, W, 3) -> ImageNet-normalized `dtype` tensor."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=images.device) * 255.0
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                       device=images.device) * 255.0
    return ((images.to(torch.float32) - mean) / std).to(dtype)


def center_crop(images, crop=224):
    """(..., H, W, 3) -> (..., crop, crop, 3) center crop."""
    h, w = images.shape[-3], images.shape[-2]
    top = (h - crop) // 2
    left = (w - crop) // 2
    return images[..., top:top + crop, left:left + crop, :]


def five_crop(images, crop=224):
    """(B, H, W, 3) -> (B, 5, crop, crop, 3): 4 corners + center."""
    h, w = images.shape[-3], images.shape[-2]
    tl = images[..., :crop, :crop, :]
    tr = images[..., :crop, w - crop:, :]
    bl = images[..., h - crop:, :crop, :]
    br = images[..., h - crop:, w - crop:, :]
    cc = center_crop(images, crop)
    return torch.stack([tl, tr, bl, br, cc], dim=-4)


def ten_crop(images, crop=224):
    """(B, H, W, 3) -> (B, 10, crop, crop, 3): five-crop + h-flips."""
    five = five_crop(images, crop)
    return torch.cat([five, five.flip(-2)], dim=-4)


def make_crops(images, n_crops=10, crop=224):
    """Dispatch on crop count: 1 (center), 5, or 10. Returns
    (B, n_crops, crop, crop, 3)."""
    if n_crops == 1:
        return center_crop(images, crop)[:, None]
    if n_crops == 5:
        return five_crop(images, crop)
    if n_crops == 10:
        return ten_crop(images, crop)
    raise ValueError(f"n_crops must be 1, 5 or 10; got {n_crops}")


def eval_pipeline(images_u8, n_crops=10, crop=224, dtype=torch.bfloat16):
    """uint8 (B, base, base, 3) -> normalized (B*n_crops, crop, crop, 3),
    contiguous NHWC, crops of one image adjacent."""
    x = normalize(images_u8, dtype)
    crops = make_crops(x, n_crops, crop)
    return crops.reshape((-1,) + tuple(crops.shape[-3:]))


def shift_s8(images_u8):
    """uint8 pixels -> (pixel - 128) int8, exact: the int8 network's input
    (its stem folds the normalization in)."""
    return (images_u8.to(torch.int16) - 128).to(torch.int8)


def eval_pipeline_s8(images_u8, n_crops=10, crop=224):
    """uint8 (B, base, base, 3) -> (pixel - 128) int8 crops
    (B*n_crops, crop, crop, 3), contiguous NHWC, crops of one image adjacent:
    the int8 serving path's input (`models/quant.py`)."""
    crops = make_crops(shift_s8(images_u8), n_crops, crop)
    return crops.reshape((-1,) + tuple(crops.shape[-3:])).contiguous()

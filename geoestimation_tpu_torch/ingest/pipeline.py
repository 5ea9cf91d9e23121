"""Device image pipeline: evaluation crops and training augmentation.

The port of `geoestimation_tpu/ingest/pipeline.py`. The host hands the
device a uint8 (B, base, base, 3) tensor; normalization runs in float32,
cast last. Tensors stay NHWC.

Evaluation: normalization first, then the crops are slices and flips of the
normalized image; ten-crop = 4 corners + center of the base image at `crop`
resolution, plus the horizontal flips of all five (torchvision's TenCrop).

Training: a random crop (or a random resized crop of one size per step)
with per-image flips, then normalization. Each augmentation is split into
its draws (`crop_draws`, made on the host from `(seed, step)` alone, so a
resumed run draws what an unbroken run draws) and a pure function of those
draws (`crop_flip`, `resized_crop_flip`). In several processes the draws
are the global batch's, and each process takes those of its own rows.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .decode import IMAGENET_MEAN, IMAGENET_STD


def _upload(t, device):
    """The host tensor `t` on `device`; to a card from pinned memory, in a
    copy that does not wait for the card (from pageable memory it would
    wait for every launch queued before it)."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@functools.lru_cache(maxsize=None)
def _mean_std(device):
    """The float32 ImageNet mean and std on the 0-255 scale, made once per
    device."""
    return tuple(_upload(torch.tensor(v, dtype=torch.float32), device) * 255.0
                 for v in (IMAGENET_MEAN, IMAGENET_STD))


def normalize(images, dtype=torch.bfloat16):
    """uint8 (..., H, W, 3) -> ImageNet-normalized `dtype` tensor."""
    mean, std = _mean_std(images.device)
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


# -- training augmentation -------------------------------------------------------

def resized_crop_sizes(base, scale=(0.66, 1.0), n_sizes=8):
    """The window sizes a random resized crop picks from, one per step:
    `n_sizes` sizes spanning sqrt(scale) * base."""
    lo = max(1, int(np.floor(base * float(scale[0]) ** 0.5)))
    hi = min(base, int(np.ceil(base * float(scale[1]) ** 0.5)))
    return sorted({int(round(s)) for s in np.linspace(lo, hi, n_sizes)})


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator that depends on `(seed, step)` alone."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(
        (int(state[0]) << 31 | int(state[1])) & (2 ** 63 - 1))


def _resized(crop_scale):
    return crop_scale is not None and tuple(crop_scale) != (1.0, 1.0)


def crop_draws(gen: torch.Generator, b, h, w, crop=224, crop_scale=None):
    """The draws of one step's augmentation of b (h, w) images, on the host:
    {"size": the window side, "tops", "lefts": (b,) int64 window offsets,
    "flips": (b,) bool}. With `crop_scale` (other than (1, 1)) the size is
    one of `resized_crop_sizes(min(h, w), crop_scale)`, drawn once for the
    step, and the offsets scale uniform draws to the free range; otherwise
    the size is `crop`."""
    if _resized(crop_scale):
        sizes = resized_crop_sizes(min(h, w), tuple(crop_scale))
        size = sizes[int(torch.randint(len(sizes), (), generator=gen))]
        off_u = torch.rand(b, 2, generator=gen)
        tops = (off_u[:, 0] * (h - size + 1)).long()
        lefts = (off_u[:, 1] * (w - size + 1)).long()
    else:
        size = crop
        tops = torch.randint(h - crop + 1, (b,), generator=gen)
        lefts = torch.randint(w - crop + 1, (b,), generator=gen)
    flips = torch.rand(b, generator=gen) < 0.5
    return {"size": size, "tops": tops, "lefts": lefts, "flips": flips}


def _pack_draws(draws):
    """The offsets and flips of `crop_draws`' draws as one (3, b) int64
    tensor: tops, lefts, flips."""
    return torch.stack([draws[k].to(torch.int64)
                        for k in ("tops", "lefts", "flips")])


def _unpack_draws(size, packed):
    return {"size": size, "tops": packed[0], "lefts": packed[1],
            "flips": packed[2] != 0}


def _draws_on(draws, device):
    """`crop_draws`' draws with the offsets and flips on `device`: host
    draws bound for a card go up packed, in one `_upload`; others are left
    as they are (`_windows` and `_flip` move them)."""
    if draws["tops"].device == device or device.type != "cuda":
        return draws
    return _unpack_draws(draws["size"], _upload(_pack_draws(draws), device))


def _windows(images, size, tops, lefts):
    """(B, H, W, C) -> (B, size, size, C): each image's window at its own
    offset, one gather."""
    ar = torch.arange(size, device=images.device)
    rows = (tops.to(images.device)[:, None] + ar)[:, :, None]
    cols = (lefts.to(images.device)[:, None] + ar)[:, None, :]
    batch = torch.arange(images.shape[0], device=images.device)[:, None, None]
    return images[batch, rows, cols]


def _flip(images, flips):
    return torch.where(flips.to(images.device)[:, None, None, None],
                       images.flip(2), images)


def crop_flip(images_u8, size, tops, lefts, flips):
    """Random crop + horizontal flip on given draws: uint8 (B, H, W, 3) ->
    uint8 (B, size, size, 3), the JAX package's `random_crop_flip`."""
    return _flip(_windows(images_u8, size, tops, lefts), flips)


@functools.lru_cache(maxsize=64)
def _triangle_weights(n_in, n_out, device):
    """(n_in, n_out) float32 weights of `jax.image.resize(..., "bilinear")`
    along one axis: a triangle kernel, widened by n_in / n_out when it
    downsamples (antialiasing), each column normalized, in the float32
    arithmetic of `jax.image.scale.compute_weight_mat`; on `device`, made
    once for each size (a step's window is one of `resized_crop_sizes`'
    few)."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.5))
    x = np.abs(sample_f[None, :]
               - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    weights = np.maximum(np.float32(0), np.float32(1) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return _upload(torch.from_numpy(
        np.where(inside[None, :], weights, 0).astype(np.float32)), device)


def resize_bilinear(images, size):
    """float32 (B, S, S, C) -> (B, size, size, C) as `jax.image.resize(...,
    "bilinear")` computes it (antialiased when it downsamples): one
    separable weight matrix per axis."""
    s = images.shape[1]
    if s == size:
        return images
    w = _triangle_weights(s, size, images.device)
    return torch.einsum("bhwc,hH,wW->bHWc", images, w, w)


def resized_crop_flip(images_u8, size, tops, lefts, flips, crop=224):
    """Random resized crop + horizontal flip on given draws: uint8
    (B, H, W, 3) -> float32 (B, crop, crop, 3) in [0, 255], the JAX
    package's `random_resized_crop_flip`: each window resized to `crop`,
    flipped, clipped."""
    out = resize_bilinear(_windows(images_u8, size, tops, lefts).float(),
                          crop)
    return _flip(out, flips).clamp(0.0, 255.0)


def augment(images_u8, draws, crop=224, crop_scale=None):
    """The augmentation `crop_draws` drew, applied on the device."""
    draws = _draws_on(draws, images_u8.device)
    if _resized(crop_scale):
        return resized_crop_flip(images_u8, crop=crop, **draws)
    return crop_flip(images_u8, **draws)


def draw_rows(draws, lo, hi):
    """The draws of rows [lo, hi) of a batch's `crop_draws`."""
    return {k: v if k == "size" else v[lo:hi] for k, v in draws.items()}


def train_pipeline(images_u8, seed, step, crop=224, dtype=torch.bfloat16,
                   crop_scale=None, draws=None, shard=(0, 1)):
    """uint8 (B, base, base, 3) -> augmented normalized (B, crop, crop, 3).

    The draws come from `(seed, step)` (`step_generator`, `crop_draws`)
    unless given. crop_scale: optional (min, max) area-scale range for the
    random resized crop (config train_params.train_crop_scale); None = plain
    random crop. shard=(p, n): the B images are rows [p*B, (p+1)*B) of a
    global batch of n*B, whose draws are made and this share taken."""
    if draws is None:
        b, h, w, _ = images_u8.shape
        p, n = shard
        draws = crop_draws(step_generator(seed, step), b * n, h, w, crop,
                           crop_scale)
        if n > 1:
            draws = draw_rows(draws, p * b, (p + 1) * b)
    return normalize(augment(images_u8, draws, crop, crop_scale), dtype)

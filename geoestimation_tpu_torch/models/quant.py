"""Int8 post-training-quantized inference path (`--precision 8`).

The port of `geoestimation_tpu/models/quant.py`. The scheme is the JAX
package's (standard per-channel-weight, per-tensor-activation PTQ):

  * BatchNorm folded into the conv weights first (float32, numpy, the same
    expressions as the JAX package, so the integers come out identical).
  * Weights: symmetric per-output-channel int8 (`s_w[o] = absmax / 127`).
  * Activations: symmetric per-tensor int8 with calibrated scales (absmax,
    or a percentile of a stride subsample, over a calibration set run in
    float32), or the statistic whose int8 forward best matches the float32
    one (`autoselect_scales`, `--calib_stat auto`).
  * Every conv is s8 x s8 -> s32 followed by a float32 rescale, bias,
    optional residual, clip and round to int8, all in one hand-written CUDA
    kernel (`ops/conv_s8.py`, `csrc/conv_s8.cu`): only int8 reaches memory
    between convolutions. The multipliers are folded on the host.
  * Post-relu activations are zero at zero, so zero padding of every 3x3
    conv is exact.

The stem folds ImageNet normalization into its conv, so the network takes
raw (pixel - 128) int8 crops; borders are padded with the per-channel value
round(mean255 - 128) ("pixel == dataset mean"). It runs as a 4x4 stride-1
conv over a space-to-depth buffer (2x2 pixel blocks folded into 12
channels, padded to 16 with zero channels and zero weights), the same
integer math as the 7x7 stride-2 conv.

`state_dict` is the port's classifier state dict (torchvision names); the
quantized network keeps the JAX package's block names (`layer{s}_block{b}`)
and HWIO int8 weights, so `weights_hash` of a checkpoint equals the JAX
package's and a scales cache written by either package is accepted by the
other. The heads run in bf16 as the fast path's (`fast_infer.head_forward`,
an ISN checkpoint's scene routing included); `feature_tta` runs the stem and
layer1..level once on the base image (and its mirror) and the rest per
window, with the fast path's feature-TTA geometry. Not ported: the TPU perf
probe `GEO_REQUANT_PROBE`; the JAX package's `GEO_POOL_MODE` picks between
two bit-identical pool forms, and the port has one.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ingest.decode import IMAGENET_MEAN, IMAGENET_STD
from ..ingest.pipeline import eval_pipeline, eval_pipeline_s8
from ..ops.conv_s8 import conv_s8, conv_s8_reference
from .fast_infer import (
    check_feature_tta,
    check_square,
    ftta_mirror_concat,
    ftta_windows,
    head_forward,
    head_weights,
)
from .resnet import BN_EPSILON, STAGE_SIZES

_QMAX = 127.0
AUTO_CANDIDATE_STATS = ("absmax", "p999", "p9999")


def requant_rounding_mode():
    """Serving rounding mode of the activation requant (GEO_REQUANT_MODE):
    'half_up' (default): q = clip(floor(y + 0.5), lo, 127), the +0.5 folded
    into each requant's bias; 'rne': round half to even. Weight quantization
    stays round-half-to-even in both."""
    return os.environ.get("GEO_REQUANT_MODE", "half_up")


def round_like_serving(y, mode=None):
    """Round `y` as the serving requant does under `mode` (default: the
    current `requant_rounding_mode()`)."""
    if mode is None:
        mode = requant_rounding_mode()
    if mode == "half_up":
        return torch.floor(y + 0.5)
    return torch.round(y)


def weight_qmax():
    """Weight-grid ceiling 2^(bits-1) - 1, bits from GEO_WEIGHT_BITS
    (default 8 -> 127); sub-8-bit grids still ship as int8."""
    bits = int(os.environ.get("GEO_WEIGHT_BITS", "8"))
    if not 2 <= bits <= 8:
        raise ValueError(f"GEO_WEIGHT_BITS={bits} outside [2, 8]")
    return float((1 << (bits - 1)) - 1)


def _quant_weight(k):
    """Per-output-channel symmetric int8. k: (..., O) float32 numpy.
    Returns (k_q int8, s_w float32 (O,))."""
    wq = weight_qmax()
    s = np.max(np.abs(k.reshape(-1, k.shape[-1])), axis=0) / wq
    s = np.where(s == 0, 1.0, s).astype(np.float32)
    q = np.clip(np.round(k / s), -wq, wq).astype(np.int8)
    return q, s


def max_pool_3x3_s2(y):
    """3x3 stride-2 max pool of an NHWC integer map with one pixel of
    padding (the lowest value of the dtype), as an elementwise max over the
    9 strided window taps (the JAX package's 'slices' form, equal to its
    reduce_window form)."""
    b, h, w, c = y.shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    yp = torch.full((b, h + 3, w + 3, c), torch.iinfo(y.dtype).min,
                    dtype=y.dtype, device=y.device)
    yp[:, 1:h + 1, 1:w + 1] = y
    out = None
    for i in range(3):
        for j in range(3):
            tap = yp[:, i:i + 2 * ho - 1:2, j:j + 2 * wo - 1:2]
            out = tap if out is None else torch.maximum(out, tap)
    return out.contiguous()


# -- host side: fold and quantize ----------------------------------------------

def _fold_bn(kernel, bn_scale, bn_bias, bn_mean, bn_var, eps=BN_EPSILON):
    """BatchNorm folded into an HWIO kernel + bias, in numpy float32: the
    JAX package's expressions (the torch twin is `ops.fused_bottleneck.
    fold_bn`), so the folded values are bitwise the same."""
    g = bn_scale / np.sqrt(bn_var + eps)
    folded_kernel = kernel * g.reshape((1,) * (kernel.ndim - 1) + (-1,))
    folded_bias = bn_bias - bn_mean * g
    return folded_kernel, folded_bias


def _np(sd, key):
    return sd[key].detach().to("cpu", torch.float32).numpy()


def _fold(sd, conv, bn, eps):
    """The folded conv `conv` of the state dict: OIHW -> HWIO numpy."""
    kernel = np.ascontiguousarray(_np(sd, f"{conv}.weight").transpose(2, 3, 1, 0))
    return _fold_bn(kernel, _np(sd, f"{bn}.weight"), _np(sd, f"{bn}.bias"),
                    _np(sd, f"{bn}.running_mean"), _np(sd, f"{bn}.running_var"),
                    eps)


def _fold_block(sd, prefix, eps):
    out = {conv: _fold(sd, f"{prefix}.{conv}", f"{prefix}.{bn}", eps)
           for conv, bn in (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"))}
    if f"{prefix}.downsample.0.weight" in sd:
        out["downsample"] = _fold(sd, f"{prefix}.downsample.0",
                                  f"{prefix}.downsample.1", eps)
    return out


def _block_names(stage_sizes):
    """(JAX block name, state-dict prefix, stride) of every bottleneck."""
    return [(f"layer{s + 1}_block{b}", f"backbone.layer{s + 1}.{b}",
             2 if s > 0 and b == 0 else 1)
            for s, n in enumerate(stage_sizes) for b in range(n)]


def _stem_fold(sd, eps):
    """The stem folded with BatchNorm and ImageNet normalization:
    conv(norm(u8)) == conv_w'(u8 - 128) + b'' with w' = w / std255_c and
    b'' = b + sum_{t,c} w'[t, c, o] (128 - mean255_c)."""
    stem_k, stem_b = _fold(sd, "backbone.conv1", "backbone.bn1", eps)
    mean255 = np.asarray(IMAGENET_MEAN, np.float32) * 255.0
    std255 = np.asarray(IMAGENET_STD, np.float32) * 255.0
    wp = stem_k / std255[None, None, :, None]
    bpp = stem_b + np.einsum("hwco,c->o", wp, 128.0 - mean255)
    return wp, bpp, mean255


def quantize_model(state_dict, arch="resnet50", eps=BN_EPSILON):
    """Host-side fold + quantize of the port's state dict. Returns the static
    quantized net (no activation scales yet -- see `calibrate`), with the
    JAX package's structure: HWIO int8 weights under its block names."""
    sd = state_dict
    stage_sizes = STAGE_SIZES[arch]
    wp, bpp, mean255 = _stem_fold(sd, eps)
    stem_q, stem_sw = _quant_weight(wp)
    # explicit border pad value: "pixel == dataset mean", rounded
    pad_val = np.clip(np.round(mean255 - 128.0), -128, 127).astype(np.int8)
    blocks = {}
    for name, prefix, _ in _block_names(stage_sizes):
        qb = {}
        for cname, (k, b) in _fold_block(sd, prefix, eps).items():
            kq, sw = _quant_weight(k)
            qb[cname] = (kq, sw, b.astype(np.float32))
        blocks[name] = qb
    # the heads only, in the JAX package's layout: (in, out) kernels
    def linear(name):
        return {"kernel": np.ascontiguousarray(_np(sd, f"{name}.weight").T),
                "bias": _np(sd, f"{name}.bias")}

    isn = "scene_head.weight" in sd
    heads = ({"scene_head": linear("scene_head"),
              "scene_geo_heads": linear("scene_geo_heads")} if isn
             else {"heads": {"fused_head": linear("heads.fused_head")}})
    return {
        "arch": arch,
        "stage_sizes": stage_sizes,
        "stem": (stem_q, stem_sw, bpp.astype(np.float32)),
        "stem_pad_val": pad_val,
        "blocks": blocks,
        "isn": isn,
        "heads": heads,
    }


# -- scales: sites, identity, the cache format ----------------------------------

def site_names(stage_sizes):
    """Every activation-scale site of the int8 net: the stem, three per
    block, plus the standalone conv3 requant site (`_y3`) of each
    stage-entry block."""
    names = ["stem"]
    for stage, n_blocks in enumerate(stage_sizes):
        for bidx in range(n_blocks):
            p = f"layer{stage + 1}_block{bidx}"
            names += [f"{p}_m1", f"{p}_m2", f"{p}_out"]
            if bidx == 0:
                names.append(f"{p}_y3")
    return names


def scales_valid(scales, arch="resnet50") -> bool:
    """True iff `scales` is a complete, sane site -> scale mapping for
    `arch` (exact key set, positive finite floats)."""
    if not isinstance(scales, dict):
        return False
    if set(scales) != set(site_names(STAGE_SIZES[arch])):
        return False
    try:
        return all(np.isfinite(v) and v > 0 for v in scales.values())
    except TypeError:
        return False


def weights_hash(qnet) -> str:
    """Short stable identity of the quantized network's integer weights:
    sha256 over the arch, the stem's and every block's int8 HWIO bytes in
    sorted name order -- the JAX package's bytes in its order, so the two
    packages agree on a checkpoint's hash."""
    h = hashlib.sha256()
    h.update(qnet["arch"].encode())
    h.update(np.ascontiguousarray(qnet["stem"][0]).tobytes())
    for name in sorted(qnet["blocks"]):
        qb = qnet["blocks"][name]
        for cname in sorted(qb):
            h.update(np.ascontiguousarray(qb[cname][0]).tobytes())
    return h.hexdigest()[:16]


def pack_scales(scales, *, weights_hash, source, n_images, stat="absmax",
                headroom=1.0, calib_fingerprint=None, **extra):
    """Raw {site: scale} -> the versioned on-disk format (v2) with its
    provenance (source, distinct images, statistic, headroom, optional
    calibration-set fingerprint, the weights hash, and any non-None
    `extra`, e.g. the pixel pipeline)."""
    prov = {
        "weights_hash": weights_hash,
        "source": source,
        "n_images": int(n_images),
        "stat": stat,
        "headroom": float(headroom),
    }
    if calib_fingerprint is not None:
        prov["calib_fingerprint"] = calib_fingerprint
    prov.update({k: v for k, v in extra.items() if v is not None})
    return {
        "version": 2,
        "scales": {k: float(v) for k, v in scales.items()},
        "provenance": prov,
    }


def unpack_scales(obj, arch, expect_hash=None):
    """Validate a loaded scales file: (scales, provenance), or
    (None, reason). Only the v2 format is accepted; with `expect_hash`, a
    different weights hash rejects the file."""
    if not isinstance(obj, dict):
        return None, "not a dict"
    if obj.get("version") != 2:
        return None, "legacy/unknown scales format (expected version 2)"
    scales = obj.get("scales")
    if not scales_valid(scales, arch):
        return None, f"site map invalid for arch {arch!r}"
    prov = obj.get("provenance")
    if not isinstance(prov, dict):
        return None, "missing provenance"
    if expect_hash is not None and prov.get("weights_hash") != expect_hash:
        return None, (f"weights hash mismatch (file "
                      f"{prov.get('weights_hash')!r} != model "
                      f"{expect_hash!r})")
    return scales, prov


def unify_stage_out_scales(scales, stage_sizes):
    """Set every block's `_out` scale within a stage to the stage max, so
    each identity block's residual multiplier s_in / s_out is exactly 1."""
    out = dict(scales)
    for stage, n_blocks in enumerate(stage_sizes):
        keys = [f"layer{stage + 1}_block{b}_out" for b in range(n_blocks)]
        m = max(out[k] for k in keys)
        for k in keys:
            out[k] = m
    return out


# -- calibration: the float32 folded traversal -----------------------------------

def _nhwc_flat(x):
    """An NCHW activation flattened in NHWC order (the JAX package's), so a
    stride subsample picks the same elements."""
    return x.permute(0, 2, 3, 1).reshape(-1)


def _stat_fn(stat):
    """Reduction recorded at each calibration site: 'absmax' (max |x|), or
    'p999' / 'p9999', a percentile of |x| over a stride subsample of at most
    about 2^20 elements."""
    if stat == "absmax":
        return lambda x: x.abs().max()
    if stat in ("p999", "p9999"):
        q = 0.999 if stat == "p999" else 0.9999

        def f(x):
            flat = _nhwc_flat(x).abs()
            step = max(1, flat.shape[0] // (1 << 20))
            return torch.quantile(flat[::step], q)

        return f
    raise ValueError(f"unknown calibration stat {stat!r}")


def _oihw(k, b, device):
    """An HWIO float32 kernel and its bias -> (OIHW channels-last kernel,
    (C, 1, 1) bias) on `device`."""
    return (torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
            .to(device).contiguous(memory_format=torch.channels_last),
            torch.from_numpy(np.array(b, np.float32)).to(device)[:, None,
                                                                None])


def _folded_blocks(state_dict, arch, eps, device):
    """The BN-folded float32 blocks on `device`: [(name, stride, {conv:
    (kernel, bias)})] as `_oihw` lays them out."""
    return [(name, stride, {c: _oihw(*kb, device) for c, kb in
                            _fold_block(state_dict, prefix, eps).items()})
            for name, prefix, stride in _block_names(STAGE_SIZES[arch])]


def _folded_conv(v, kb, s=1, pad=0):
    return F.conv2d(v, kb[0], None, s, pad) + kb[1]


def folded_trunk(x, blocks, site=None):
    """The max pool and every block of the folded float32 network on the
    stem's NCHW output `x`, calling `site(name, y)` at each requant site;
    returns the last map. Shared by the calibration traversal and the
    float32 teacher (`qat.build_qat_apply`)."""
    site = site or (lambda name, y: None)
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for name, stride, fb in blocks:
        y = torch.relu(_folded_conv(x, fb["conv1"]))
        site(f"{name}_m1", y)
        y = torch.relu(_folded_conv(y, fb["conv2"], stride, 1))
        site(f"{name}_m2", y)
        y = _folded_conv(y, fb["conv3"])
        if "downsample" in fb:
            # entry blocks: conv3 requantizes standalone (site _y3)
            site(f"{name}_y3", y)
            res = _folded_conv(x, fb["downsample"], stride)
        else:
            res = x
        x = torch.relu(y + res)
        site(f"{name}_out", x)
    return x


def _make_traversal_fn(state_dict, arch, eps, record, device):
    """The float32 folded network with `record(x)` at every requant site:
    returns `f(images) -> {site: record}` for normalized NHWC float32
    images. Convolutions run in float32 on `device` (TF32 off on CUDA)."""
    device = torch.device(device)
    stem = _oihw(*_fold(state_dict, "backbone.conv1", "backbone.bn1", eps),
                 device)
    blocks = _folded_blocks(state_dict, arch, eps, device)

    def f(images):
        rec = {}

        def site(name, y):
            rec[name] = record(y)

        x = images.to(torch.float32).permute(0, 3, 1, 2)
        x = torch.relu(_folded_conv(x, stem, 2, 3))
        site("stem", x)
        folded_trunk(x, blocks, site)
        return rec

    return torch.inference_mode()(f)


def make_calibration_fn(state_dict, arch="resnet50", eps=BN_EPSILON,
                        stat="absmax", device="cuda"):
    """`f(images_norm_f32) -> {site: stat(|x|)}` over the float32 folded
    net (`_stat_fn`); feed it `eval_pipeline(..., dtype=torch.float32)`
    crops."""
    return _make_traversal_fn(state_dict, arch, eps, _stat_fn(stat), device)


def calibrate(state_dict, batches_u8, arch="resnet50", eps=BN_EPSILON,
              n_crops=10, crop=224, headroom=1.0, stat="absmax",
              device="cuda"):
    """The float32 folded net over uint8 base-image batches -> {site: scale}
    (stat(|x|) / 127 * headroom). Batches combine by max for 'absmax' and
    by the mean of per-batch percentiles otherwise."""
    f = make_calibration_fn(state_dict, arch, eps, stat=stat, device=device)
    acc = None
    n_batches = 0
    for u8 in batches_u8:
        crops = eval_pipeline(torch.as_tensor(np.asarray(u8)).to(device),
                              n_crops=n_crops, crop=crop, dtype=torch.float32)
        rec = {k: np.float32(v.item()) for k, v in f(crops).items()}
        n_batches += 1
        if acc is None:
            acc = dict(rec)
        elif stat == "absmax":
            acc = {k: max(acc[k], rec[k]) for k in rec}
        else:
            acc = {k: acc[k] + rec[k] for k in rec}
    if acc is None:
        raise ValueError("calibrate() needs at least one batch")
    if stat != "absmax" and n_batches > 1:
        acc = {k: v / n_batches for k, v in acc.items()}
    return {k: float(v) / _QMAX * headroom if v > 0 else 1.0
            for k, v in acc.items()}


def make_sampling_calibration_fn(state_dict, arch="resnet50", eps=BN_EPSILON,
                                 n_cap=1 << 17, device="cuda"):
    """`f(images_norm_f32) -> {site: (absmax, sample)}`: the exact max |x|
    and a stride subsample of |x| (NHWC order, at most about n_cap
    elements) at every requant site, from one float32 pass."""

    def record(x):
        flat = _nhwc_flat(x).abs()
        step = max(1, flat.shape[0] // n_cap)
        return flat.max(), flat[::step]

    return _make_traversal_fn(state_dict, arch, eps, record, device)


def calibrate_samples(state_dict, batches_u8, arch="resnet50", eps=BN_EPSILON,
                      n_crops=10, crop=224, n_cap=1 << 17, pool_cap=1 << 20,
                      device="cuda"):
    """The sampling calibration over uint8 base-image batches:
    {site: (absmax float, pooled |x| sample numpy)}, each pool capped at
    `pool_cap` elements by stride halving."""
    f = make_sampling_calibration_fn(state_dict, arch, eps, n_cap=n_cap,
                                     device=device)
    amax: dict = {}
    pools: dict = {}
    for u8 in batches_u8:
        crops = eval_pipeline(torch.as_tensor(np.asarray(u8)).to(device),
                              n_crops=n_crops, crop=crop, dtype=torch.float32)
        for k, (m, vec) in f(crops).items():
            vec = vec.cpu().numpy()
            amax[k] = max(amax.get(k, 0.0), float(m))
            pool = np.concatenate([pools[k], vec]) if k in pools else vec
            while pool.size > pool_cap:
                pool = pool[::2]
            pools[k] = pool
    if not amax:
        raise ValueError("calibrate_samples() needs at least one batch")
    return {k: (amax[k], pools[k]) for k in amax}


def derive_scales(samples, stat="absmax", headroom=1.0):
    """{site: (absmax, pooled sample)} -> {site: scale} for one (stat,
    headroom); percentiles come from the pooled cross-batch sample."""
    if stat == "absmax":
        vals = {k: m for k, (m, _) in samples.items()}
    elif stat in ("p999", "p9999"):
        q = 0.999 if stat == "p999" else 0.9999
        vals = {k: float(np.quantile(pool, q)) if pool.size else 0.0
                for k, (_, pool) in samples.items()}
    else:
        raise ValueError(f"unknown calibration stat {stat!r}")
    return {k: v / _QMAX * headroom if v > 0 else 1.0
            for k, v in vals.items()}


# -- the int8 forward --------------------------------------------------------------

def _kmat(kq, cin_multiple=1):
    """HWIO int8 -> the kernel's (Cout, KH*KW*Cin) layout, the input
    channels zero-padded to a multiple of `cin_multiple`."""
    pad = -kq.shape[2] % cin_multiple
    if pad:
        kq = np.pad(kq, ((0, 0), (0, 0), (0, pad), (0, 0)))
    return np.ascontiguousarray(kq.transpose(3, 0, 1, 2).reshape(kq.shape[3], -1))


def _prefold(qnet, act_scales):
    """Every requant multiplier and bias, folded on the host with the JAX
    package's numpy float32 expressions in its order (a scale is a Python
    float for `build_int8_apply`, a float32 for the dynamic variant, as in
    the JAX package), with half_up's +0.5 folded into the biases."""
    half = 0.5 if requant_rounding_mode() == "half_up" else 0.0
    f32 = np.float32
    stage_sizes = qnet["stage_sizes"]
    s_stem = act_scales["stem"]
    _, stem_sw, stem_b = qnet["stem"]
    out = {"stem": (np.asarray(stem_sw / s_stem, f32),
                    np.asarray(stem_b / s_stem, f32) + half)}
    prev = "stem"
    for name, _, _ in _block_names(stage_sizes):
        qb = qnet["blocks"][name]
        s_in = act_scales[prev]
        s1 = act_scales[f"{name}_m1"]
        s2 = act_scales[f"{name}_m2"]
        s_out = act_scales[f"{name}_out"]
        _, sw1, b1 = qb["conv1"]
        _, sw2, b2 = qb["conv2"]
        _, sw3, b3 = qb["conv3"]
        fb = {"m1": np.asarray(s_in * sw1 / s1, f32),
              "a1": np.asarray(b1 / s1, f32) + half,
              "m2": np.asarray(s1 * sw2 / s2, f32),
              "a2": np.asarray(b2 / s2, f32) + half}
        if "downsample" in qb:
            s_y3 = act_scales[f"{name}_y3"]
            _, swd, bd = qb["downsample"]
            fb.update(m3=np.asarray(s2 * sw3 / s_y3, f32),
                      a3=np.asarray(b3 / s_y3, f32) + half,
                      g3=f32(s_y3 / s_out),
                      md=np.asarray(s_in * swd / s_out, f32),
                      ad=np.asarray(bd / s_out + half, f32))
        else:
            fb.update(m3=np.asarray(s2 * sw3 / s_out, f32),
                      a3=np.asarray(b3 / s_out + half, f32),
                      md=f32(s_in / s_out))
        out[name] = fb
        prev = f"{name}_out"
    out["s_last"] = f32(act_scales[prev])
    return out


def _upload(pf, device):
    """The prefolded multipliers on `device`, copied once per build rather
    than once per forward (a copy from pageable host memory waits for the
    stream); scalars stay float32 scalars."""
    def dev(v):
        return v if np.ndim(v) == 0 else torch.as_tensor(v, device=device)

    return {k: (tuple(map(dev, v)) if isinstance(v, tuple)
                else {n: dev(a) for n, a in v.items()} if isinstance(v, dict)
                else v) for k, v in pf.items()}


def _int8_net(qnet, n_classes=None, feature_tta=None, device="cuda",
              plain=False):
    """The int8 network on `device`, its weights laid out and copied once:
    returns `forward(images_s8, uploaded prefolded multipliers) -> [per-head
    logits]`, with
    `.stem_fn`, `.block_fns` (taking the prefolded multipliers too) and
    `.head_logits` for the tests. `plain` runs every conv through the
    kernel's plain version (the card's yardstick of the kernel).
    `feature_tta` ({"crop", "n_crops", "level"}, defaults 224, 10, 3): the
    forward takes square base images and runs feature-space TTA."""
    if os.environ.get("GEO_REQUANT_PROBE", ""):
        raise NotImplementedError(
            "GEO_REQUANT_PROBE (a TPU perf probe, never for serving) is not "
            "ported")
    device = torch.device(device)
    rne = requant_rounding_mode() != "half_up"
    conv = conv_s8_reference if plain else conv_s8

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    # --- stem: space-to-depth, 8x8 taps (7x7 + a zero row and column) folded
    # to 4x4 over 2x2 pixel blocks, 12 channels padded to 16 ---
    stem_q = qnet["stem"][0]
    c_in = stem_q.shape[2]
    k8 = np.zeros((8, 8) + stem_q.shape[2:], np.int8)
    k8[:7, :7] = stem_q
    k4 = (k8.reshape(4, 2, 4, 2, *stem_q.shape[2:]).transpose(0, 2, 1, 3, 4, 5)
          .reshape(4, 4, 4 * c_in, stem_q.shape[3]))
    stem_w = dev(_kmat(k4, 16))
    stem_cin = stem_w.shape[1] // 16
    pad_val = dev(qnet["stem_pad_val"], torch.int8)

    def stem_fn(x_s8, pf):
        b, h, w, c = x_s8.shape
        if h % 2 or w % 2:
            raise ValueError(
                f"int8 stem requires even crop dims (got {h}x{w}): the "
                "space-to-depth formulation folds 2x2 pixel blocks into "
                "channels, so h+8 and w+8 must be even")
        # 3 px of "pixel == dataset mean", plus 2 trailing rows/cols so block
        # space is even (read only by the zero taps)
        buf = pad_val.expand(b, h + 8, w + 8, c).clone()
        buf[:, 3:h + 3, 3:w + 3] = x_s8
        hb, wb = (h + 8) // 2, (w + 8) // 2
        x2 = torch.zeros((b, hb, wb, stem_cin), dtype=torch.int8,
                         device=x_s8.device)
        x2[..., :4 * c] = (buf.reshape(b, hb, 2, wb, 2, c)
                           .permute(0, 1, 3, 2, 4, 5).reshape(b, hb, wb, 4 * c))
        h_out, w_out = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        mult, bias = pf["stem"]
        y = conv(x2, stem_w, mult, bias, (4, 4), 1, 0, (h_out, w_out), 0.0,
                 rne)
        return max_pool_3x3_s2(y)

    def make_block(name, stride, qb):
        k1, k2, k3 = (dev(_kmat(qb[c][0])) for c in ("conv1", "conv2", "conv3"))
        kd = dev(_kmat(qb["downsample"][0])) if "downsample" in qb else None

        def block(x, pf):
            p = pf[name]
            y = conv(x, k1, p["m1"], p["a1"], lo=0.0, rne=rne)
            y = conv(y, k2, p["m2"], p["a2"], (3, 3), stride, 1, lo=0.0,
                     rne=rne)
            if kd is not None:
                # entry blocks: conv3 requantizes standalone (signed, site
                # _y3); the downsample conv hosts the add, relu and requant
                y3q = conv(y, k3, p["m3"], p["a3"], lo=-_QMAX, rne=rne)
                return conv(x, kd, p["md"], p["ad"], (1, 1), stride, 0,
                            lo=0.0, rne=rne, res=y3q,
                            res_scale=float(p["g3"]), res_mode="mul_add")
            # identity blocks: conv3 + residual + relu + requant in one pass
            return conv(y, k3, p["m3"], p["a3"], lo=0.0, rne=rne, res=x,
                        res_scale=float(p["md"]))

        return block

    block_fns = [make_block(name, stride, qnet["blocks"][name])
                 for name, _, stride in _block_names(qnet["stage_sizes"])]

    # --- heads: bf16 on the mean of the last int8 map times its scale ---
    def linear(h):
        return torch.from_numpy(np.asarray(h["kernel"]).T), \
            torch.from_numpy(np.asarray(h["bias"]))

    h = qnet["heads"]
    heads = (head_weights(linear(h["scene_geo_heads"]),
                          linear(h["scene_head"]), device) if qnet["isn"]
             else head_weights(linear(h["heads"]["fused_head"]),
                               device=device))

    def head_logits(x, pf):
        # an exact float32 sum of int8 values, divided: the JAX mean's value
        feats = (x.to(torch.float32).sum(dim=(1, 2))
                 / (x.shape[1] * x.shape[2])) * float(pf["s_last"])
        return head_forward(feats, heads, n_classes)

    @torch.inference_mode()
    def forward(images_s8, pf):
        x = stem_fn(images_s8, pf)
        for blk in block_fns:
            x = blk(x, pf)
        return head_logits(x, pf)

    def feature_forward(crop, n_crops, level):
        stage_sizes = qnet["stage_sizes"]
        check_feature_tta(n_crops, level, len(stage_sizes), "feature_tta")
        n_trunk = sum(stage_sizes[:level])

        @torch.inference_mode()
        def forward(base_s8, pf):
            b, s = check_square(base_s8)
            x = stem_fn(ftta_mirror_concat(base_s8, n_crops), pf)
            for blk in block_fns[:n_trunk]:
                x = blk(x, pf)
            xc = ftta_windows(x, b, s, crop, n_crops, level)
            for blk in block_fns[n_trunk:]:
                xc = blk(xc, pf)
            return head_logits(xc, pf)

        return forward

    if feature_tta is not None:
        forward = feature_forward(int(feature_tta.get("crop", 224)),
                                  int(feature_tta.get("n_crops", 10)),
                                  int(feature_tta.get("level", 3)))
    forward.stem_fn = stem_fn
    forward.block_fns = block_fns
    forward.head_logits = head_logits
    return forward


def build_int8_apply(qnet, act_scales, n_classes=None, feature_tta=None,
                     device="cuda", plain=False):
    """Returns `apply(images_s8) -> [per-head float32 logits]`.

    `images_s8`: (pixel - 128) int8 crops (B, H, W, 3), H and W even, on
    `device` (`ingest.pipeline.eval_pipeline_s8`); with `feature_tta`
    ({"crop", "n_crops", "level"}), the square base images
    (`ingest.pipeline.shift_s8`), giving (B * n_crops) rows. `qnet` from
    `quantize_model`, `act_scales` {site: scale} from `calibrate`. Every
    conv launches `ops.conv_s8` (its plain version on the CPU, or everywhere
    with `plain=True`). `apply.stem_fn(x)`, `apply.block_fns[i](x)` and
    `apply.head_logits(x)` run the pieces with these scales, and
    `apply.stage_fns` are [stem, layer1, ..., layer4] as the fast path's
    (NHWC int8 in and out).
    """
    net = _int8_net(qnet, n_classes, feature_tta, device, plain)
    pf = _upload(_prefold(qnet, act_scales), device)

    def apply(images_s8):
        return net(images_s8, pf)

    def stage(blocks):
        def run(x):
            for block in blocks:
                x = block(x, pf)
            return x
        return run

    apply.stem_fn = lambda x: net.stem_fn(x, pf)
    apply.block_fns = [lambda x, b=b: b(x, pf) for b in net.block_fns]
    apply.head_logits = lambda x: net.head_logits(x, pf)
    ends = np.cumsum(qnet["stage_sizes"])
    apply.stage_fns = [apply.stem_fn] + [
        stage(net.block_fns[end - n:end])
        for n, end in zip(qnet["stage_sizes"], ends)]
    return apply


def build_int8_apply_dynamic(qnet, n_classes=None, feature_tta=None,
                             device="cuda"):
    """Like `build_int8_apply`, with the activation scales an argument of
    each call: `apply(images_s8, act_scales)`; the scales are taken as
    float32 (as the JAX package's dynamic graph does) and the weights are
    laid out once."""
    net = _int8_net(qnet, n_classes, feature_tta, device)

    def apply(images_s8, act_scales):
        scales = {k: np.float32(v) for k, v in act_scales.items()}
        return net(images_s8, _upload(_prefold(qnet, scales), device))

    return apply


def autoselect_scales(state_dict, batches_u8, qnet=None, *, arch="resnet50",
                      n_classes=None, n_crops=10, crop=224, headroom=1.0,
                      candidates=AUTO_CANDIDATE_STATS, samples=None,
                      eps=BN_EPSILON, device="cuda"):
    """The calibration statistic whose int8 forward best matches the float32
    forward on the calibration images themselves (`--calib_stat auto`).

    One float32 sampling pass gives every candidate's scales
    (`calibrate_samples` / `derive_scales`, or `samples` when given); each
    candidate is scored by the summed per-head KL(float32 teacher || int8
    student) on the calibration crops (`qat.teacher_student_kl`), weighted
    by images per batch. The first candidate wins exact ties.

    Returns (scales, picked_stat, {stat: mean_kl}).
    """
    from .qat import build_qat_apply, fold_variables, teacher_student_kl

    if qnet is None:
        qnet = quantize_model(state_dict, arch=arch, eps=eps)
    batches = [np.asarray(b) for b in batches_u8]
    if samples is None:
        samples = calibrate_samples(state_dict, batches, arch=arch, eps=eps,
                                    n_crops=n_crops, crop=crop, device=device)
    cand_scales = {s: derive_scales(samples, s, headroom) for s in candidates}

    folded = fold_variables(state_dict, arch=arch, eps=eps, device=device)
    teacher = build_qat_apply(arch, cand_scales[candidates[0]],
                              n_classes=n_classes, fake_quant=False)
    student = build_int8_apply_dynamic(qnet, n_classes=n_classes,
                                       device=device)
    kl_sum = {s: 0.0 for s in candidates}
    n_total = 0
    for u8 in batches:
        x_s8 = eval_pipeline_s8(torch.as_tensor(u8).to(device),
                                n_crops=n_crops, crop=crop)
        t_logits = teacher(folded, x_s8.to(torch.float32))
        w = int(u8.shape[0])
        n_total += w
        for s in candidates:
            kl_sum[s] += w * float(teacher_student_kl(
                t_logits, student(x_s8, cand_scales[s])))
    if n_total == 0:
        raise ValueError("autoselect_scales() needs at least one image")
    kls = {s: kl_sum[s] / n_total for s in candidates}
    picked = min(candidates, key=lambda s: (kls[s], candidates.index(s)))
    return cand_scales[picked], picked, kls


def build_int8_pipeline(state_dict, calib_batches_u8, arch="resnet50",
                        n_classes=None, eps=BN_EPSILON, n_crops=10, crop=224,
                        stat="absmax", device="cuda"):
    """One-call serving build: calibrate, quantize, and return
    `apply(images_u8_base) -> [per-head logits]` (ten-crop on int8 data
    inside), with `apply.scales`."""
    scales = calibrate(state_dict, calib_batches_u8, arch=arch, eps=eps,
                       n_crops=n_crops, crop=crop, stat=stat, device=device)
    qnet = quantize_model(state_dict, arch=arch, eps=eps)
    int8_apply = build_int8_apply(qnet, scales, n_classes=n_classes,
                                  device=device)

    def apply(images_u8):
        return int8_apply(eval_pipeline_s8(images_u8, n_crops=n_crops,
                                           crop=crop))

    apply.scales = scales
    return apply

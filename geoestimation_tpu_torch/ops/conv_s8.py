"""int8 convolution with the requantization fused: the CUDA kernel's wrapper
and its plain PyTorch version.

`conv_s8` (`csrc/conv_s8.cu`) is the counterpart of the int8 serving path's
convolution (`geoestimation_tpu/models/quant.py` `_conv_s8`, an XLA s8 x s8
-> s32 convolution) together with the requant XLA fuses into its consumer.
Per output pixel and channel o, with acc the int32 sum of products:

    y   = fma(float32(acc), mult[o], bias[o])
    y   = fma(float32(res), res_scale, y)        res_mode "fma": identity
    y   = float32(res) * res_scale + y           res_mode "mul_add": entry
    out = int8(clip(round(y), lo, 127))

round is floor (the serving default, `half_up`, whose +0.5 the caller folds
into `bias`) or round-half-to-even (`rne`). Each fma rounds once, each
product and sum once: XLA's CPU backend contracts the JAX package's
`acc * mult + bias` and its identity tail `y3 + x * md` into fmas, and in
the stage-entry fusion rounds `y3q * g3` before the add
(tests/test_torch_port_quant.py pins each form).

Layouts: x (N, H, W, Cin) int8; w (Cout, KH*KW*Cin) int8 in (ky, kx, c)
order; mult, bias (Cout,) float32; res, out (N, Ho, Wo, Cout) int8. The
convolution pads with zeros (`pad` on every side) and strides by `stride`;
`out_hw` keeps only the first Ho x Wo outputs (the space-to-depth stem).

`kernel_plan` is the kernel's planner: for each convolution it picks how A
is read, the tile, the warpgroups, the K sub-slice and the ring; the C
entry point checks the plan again. The CPU tests hold it to the shapes the
kernel takes (tests/test_torch_port_conv_s8.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

# What the kernel takes (checked again by its C entry point): its output
# pixel indexes and K are int32 (a tile of 128 pixels past the last one
# included); its byte offsets are 64-bit, so activations may pass 2 GiB.
CIN_MULTIPLE = 16
COUT_MULTIPLE = 8
MAX_PIXELS = 2 ** 31 - 128      # N * Ho * Wo, exclusive
MAX_WEIGHTS = 2 ** 31           # KH * KW * Cin * Cout, exclusive

# The kernel's tiling (`csrc/conv_s8.cu`): a sub-box is 64 output pixels
# (one wgmma m64 tile), a sub-slice 128 bytes of K where a tap's channels
# come in 128s, else 64 (one TMA box row, in the swizzle of that width); a
# warpgroup's tile is MT sub-boxes x BN output channels.
SUB_PIXELS = 64
FOLD_BYTES = 64
BOX_WIDTHS = (64, 32, 16, 8, 4, 2, 1)       # a sub-box is BW x (64 / BW)
TILE_SHAPES = ((2, 64), (1, 128), (1, 64))     # (MT, BN): 64 accumulators
# per consumer warpgroups of a block (1 or 2): blocks on an SM, and the
# shared memory each may use of the SM's 228 KB
BLOCKS_PER_SM = {1: 2, 2: 1}
SMEM_PER_BLOCK = {1: 112 * 1024, 2: 227 * 1024}
MAX_STAGES = 8
SLICES_PER_STAGE = (4, 2, 1)
B_RESIDENT_MAX = 64 * 1024
PARAM_MAPS = 8                 # A tensor maps passed in the launch's params
MODES = {"flat": 0, "box": 1, "fold": 2}
H100_SMS = 132


def _cdiv(a, b):
    return -(-a // b)


def _box_shape(width, height):
    """(BW, BH) of the sub-box (BW * BH = 64) that covers a width x height
    plane with the least padding; the wider of equals (longer TMA rows)."""
    def area(bw):
        return (_cdiv(width, bw) * bw) * (_cdiv(height, 64 // bw) * (64 // bw))
    bw = min(BOX_WIDTHS, key=lambda b: (area(b), -b))
    return bw, 64 // bw


def kernel_plan(n, h, w, cin, ho, wo, cout, kh, kw, stride, pad, has_res):
    """The kernel's plan for one convolution (module docs of `conv_s8.cu`),
    as a dict: the plan `conv_s8` launches with on the current CUDA device,
    sized to its SMs (to an H100's 132 where there is no card);
    `geo_conv_s8` checks it again. Raises ValueError where the kernel does
    not take the convolution.

    - mode: "flat" (a 1x1 stride-1 convolution over all its pixels: A is
      the (N*H*W, Cin) matrix), "fold" (stride 1, no padding, KW taps of Cin
      channels making 64 bytes, no residual: the space-to-depth stem; A rows
      are the KW taps of a row, 64 contiguous bytes, one map per output
      column residue mod KW), or "box" (anything else: one 4-D TMA box per
      tap and sub-box, the padding its out-of-bounds zero fill, the stride
      a map per phase);
    - bw, bh: the sub-box's output columns and rows (box and fold);
    - wg: consumer warpgroups of a block, each with its own mt sub-boxes
      of the tile and all its bn channels: 1 where the weights stay
      resident (short K, bound by bytes; two blocks an SM, so one's
      epilogue overlaps the other's products), else 2 (long K: the
      weights streamed once for both);
    - mt, bn: sub-boxes and output channels of a warpgroup's tile;
    - b_resident: all weights staged once per block (at most 64 KB);
    - sb: K bytes of a sub-slice (128 where Cin % 128 == 0, else 64);
    - g: K sub-slices a ring stage holds; stages: the ring's depth;
    - grid: persistent blocks; smem: bytes.
    """
    return dict(_plan(n, h, w, cin, ho, wo, cout, kh, kw, stride, pad,
                      bool(has_res), _sms()))


@functools.lru_cache(maxsize=None)
def _plan(n, h, w, cin, ho, wo, cout, kh, kw, stride, pad, has_res, sms):
    if cin % CIN_MULTIPLE or cout % COUT_MULTIPLE:
        raise ValueError(
            f"the CUDA kernel takes Cin % {CIN_MULTIPLE} == 0 and Cout % "
            f"{COUT_MULTIPLE} == 0; got {cin}, {cout}")
    if n * ho * wo >= MAX_PIXELS or kh * kw * cin * cout >= MAX_WEIGHTS:
        raise ValueError(
            f"the CUDA kernel takes N*Ho*Wo < {MAX_PIXELS} and KH*KW*Cin*Cout "
            f"< {MAX_WEIGHTS}; got {n * ho * wo} and {kh * kw * cin * cout}")
    if min(n, h, w, ho, wo, kh, kw, stride) < 1 or pad < 0:
        raise ValueError("the CUDA kernel takes positive sizes")
    sb = 128 if cin % 128 == 0 else 64
    if kh == kw == 1 and stride == 1 and pad == 0 and (ho, wo) == (h, w):
        mode, bw, bh = "flat", SUB_PIXELS, 1
        subs = _cdiv(n * h * w, SUB_PIXELS)
        nq, maps = _cdiv(cin, sb), 1
    elif (stride == 1 and pad == 0 and kw > 1 and kw * cin == FOLD_BYTES
          and not has_res):
        mode, sb = "fold", FOLD_BYTES
        bw, bh = _box_shape(_cdiv(wo, kw), ho)
        maps = min(kw, wo)
        subs = n * maps * _cdiv(_cdiv(wo, kw), bw) * _cdiv(ho, bh)
        nq = kh
    else:
        mode = "box"
        bw, bh = _box_shape(wo, ho)
        subs = n * _cdiv(wo, bw) * _cdiv(ho, bh)
        nq = kh * kw * _cdiv(cin, sb)
        maps = min(kh, stride) * min(kw, stride)
    res_bytes = 1 if has_res else 0
    plans = {1: [], 2: []}
    for wg in (1, 2):
        for mt, bn in TILE_SHAPES:
            nch = _cdiv(cout, bn)
            tiles = _cdiv(subs, wg * mt) * nch
            region = _cdiv((1 + res_bytes) * mt * SUB_PIXELS * bn + 8 * bn
                           + 8 * mt * SUB_PIXELS, 1024) * 1024
            # (staging, mult/bias, row offsets; whole swizzle atoms)
            fixed = wg * region + 256 + 1024   # barriers, alignment slack
            b_tile = bn * sb
            b_all = nq * nch * b_tile
            a_bytes = wg * mt * SUB_PIXELS * sb
            for resident in (True, False):
                if resident and b_all > B_RESIDENT_MAX:
                    continue
                room = SMEM_PER_BLOCK[wg] - fixed - (b_all if resident else 0)
                # sub-slices a stage: as many as divide K and leave room
                # for 3 stages (the ring runs on into the next tiles)
                per = a_bytes + (0 if resident else b_tile)
                g = next(g for g in SLICES_PER_STAGE
                         if g == 1 or (nq % g == 0 and room // (g * per) >= 3))
                stage = g * per
                stages = min(MAX_STAGES, room // stage)
                if stages < 2:
                    continue
                # the cost model: padded channels and pixels are work done
                # for nothing; too few tiles leave SMs idle
                waste = (nch * bn / cout) * (
                    _cdiv(subs, wg * mt) * wg * mt / subs)
                blocks = BLOCKS_PER_SM[wg] * sms
                fill = min(1.0, tiles / blocks)
                plans[wg].append((waste / fill, not resident, -bn, dict(
                    mode=mode, bw=bw, bh=bh, wg=wg, mt=mt, bn=bn, nch=nch,
                    sb=sb, nq=nq, g=g, subs=subs, tiles=tiles, maps=maps,
                    b_resident=resident, stages=stages, stage_bytes=stage,
                    grid=min(tiles, blocks),
                    smem=fixed + (b_all if resident else 0) + stages * stage)))
                break
    # one warpgroup where its weights stay resident, else two
    pick = [p for p in plans[1] if p[3]["b_resident"]] or plans[2] \
        or plans[1]
    if not pick:
        raise ValueError("the CUDA kernel has no plan that fits shared "
                         f"memory for this convolution (K = {kh * kw * cin})")
    return min(pick, key=lambda p: p[:3])[3]


def out_size(h, w, ksize, stride, pad):
    """Output height and width of a padded, strided convolution."""
    return ((h + 2 * pad - ksize[0]) // stride + 1,
            (w + 2 * pad - ksize[1]) // stride + 1)


def fma_f32(a, b, c):
    """float32 fma(a, b, c) with one rounding, for float32 tensors (b and c
    may be Python floats or broadcast): the float64 product of two float32
    values is exact; the float64 sum is made round-to-odd (its inexactness
    folded into the last bit) so that rounding it to float32 rounds once."""
    a, b, c = (torch.as_tensor(v, dtype=torch.float32, device=a.device)
               .double() for v in (a, b, c))
    p = a * b
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)          # s + err == p + c exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


RES_MODES = {"fma": 1, "mul_add": 2}


def requant_reference(acc, mult, bias, lo=0.0, rne=False, res=None,
                      res_scale=0.0, res_mode="fma"):
    """The kernel's epilogue on int32 accumulators `acc` (..., Cout)."""
    y = fma_f32(acc.float(), mult, bias)
    if res is not None and res_mode == "fma":
        y = fma_f32(res.float(), res_scale, y)
    elif res is not None:
        y = res.float() * torch.tensor(res_scale, dtype=torch.float32) + y
    y = torch.round(y) if rne else torch.floor(y)
    return y.clamp(lo, 127.0).to(torch.int8)


def conv_acc_reference(x, w, ksize, stride, pad, out_hw):
    """int32 accumulators (N, Ho, Wo, Cout) of the convolution, exact: the
    products and sums run in float64, where every partial sum of int8
    products (under 127 * 128 * K < 2^31 < 2^53) is an integer. cuDNN is
    kept out on CUDA: its FFT and Winograd forms are not exact."""
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    wf = w.reshape(cout, ksize[0], ksize[1], cin).permute(0, 3, 1, 2).double()
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(x.permute(0, 3, 1, 2).double(), wf, stride=stride,
                       padding=pad)
    ho, wo = out_hw
    return acc[:, :, :ho, :wo].permute(0, 2, 3, 1).to(torch.int32)


def conv_s8_reference(x, w, mult, bias, ksize=(1, 1), stride=1, pad=0,
                      out_hw=None, lo=0.0, rne=False, res=None, res_scale=0.0,
                      res_mode="fma"):
    """Plain PyTorch version of the kernel: the same function, the
    convolution exact in float64 and the same epilogue."""
    if out_hw is None:
        out_hw = out_size(x.shape[1], x.shape[2], ksize, stride, pad)
    acc = conv_acc_reference(x, w, ksize, stride, pad, out_hw)
    return requant_reference(acc, mult, bias, lo, rne, res, res_scale,
                             res_mode)


def _check(x, w, mult, bias, ksize, stride, pad, out_hw, res, res_mode):
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, Cin); got shape {tuple(x.shape)}")
    n, h, wd, cin = x.shape
    if stride < 1 or pad < 0:
        raise ValueError(f"stride {stride} and pad {pad}: need >= 1 and >= 0")
    if res_mode not in RES_MODES:
        raise ValueError(f"res_mode {res_mode!r}; have {sorted(RES_MODES)}")
    full = out_size(h, wd, ksize, stride, pad)
    ho, wo = full if out_hw is None else out_hw
    if not (0 < ho <= full[0] and 0 < wo <= full[1]):
        raise ValueError(f"out_hw {(ho, wo)} outside the convolution's "
                         f"{full}")
    cout = w.shape[0]
    shapes = {"x": (x, (n, h, wd, cin), torch.int8),
              "w": (w, (cout, ksize[0] * ksize[1] * cin), torch.int8),
              "mult": (mult, (cout,), torch.float32),
              "bias": (bias, (cout,), torch.float32)}
    if res is not None:
        shapes["res"] = (res, (n, ho, wo, cout), torch.int8)
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}; got "
                             f"{tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}; got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n, h, wd, cin, ho, wo, cout


def _sms(index=None):
    """SMs of CUDA device `index` (the current one where None), or an
    H100's where there is no card: the persistent grid the planner sizes."""
    if not torch.cuda.is_available():
        return H100_SMS
    return _device_sms(torch.cuda.current_device() if index is None
                       else index)


@functools.lru_cache(maxsize=None)
def _device_sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, built and loaded at first use."""
    fn = _build.load("conv_s8").geo_conv_s8
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.POINTER(ctypes.c_int),
                      ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(x, w, mult, bias, res, dims, ksize, stride, pad, lo, rne,
            res_scale, res_mode):
    n, h, wd, cin, ho, wo, cout = dims
    if any(t is not None and t.data_ptr() % 16
           for t in (x, w, mult, bias, res)):
        raise ValueError("the CUDA kernel needs 16-byte aligned tensors")
    plan = _plan(n, h, wd, cin, ho, wo, cout, ksize[0], ksize[1], stride, pad,
                 res is not None, _sms(x.device.index))
    fn = _entry()
    out = torch.empty((n, ho, wo, cout), dtype=torch.int8, device=x.device)
    choice = (ctypes.c_int * 11)(
        MODES[plan["mode"]], plan["bw"], plan["bh"], plan["mt"], plan["bn"],
        int(plan["b_resident"]), plan["stages"], plan["grid"], plan["wg"],
        plan["g"], plan["sb"])
    maps = None
    if plan["maps"] > PARAM_MAPS:     # 128 bytes a map, 128-byte aligned
        maps = torch.empty(128 * (plan["maps"] + 1), dtype=torch.uint8,
                           device=x.device)
    with torch.cuda.device(x.device):   # a no-op on the current device
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), mult.data_ptr(), bias.data_ptr(),
                 None if res is None else res.data_ptr(), out.data_ptr(),
                 n, h, wd, cin, ho, wo, cout, ksize[0], ksize[1], stride, pad,
                 float(lo), int(rne), 0 if res is None else RES_MODES[res_mode],
                 float(res_scale), choice,
                 None if maps is None else -(-maps.data_ptr() // 128) * 128,
                 stream)
    if err:
        raise RuntimeError(f"conv_s8 CUDA kernel failed to launch: cudaError "
                           f"{err}")
    return out


def conv_s8(x, w, mult, bias, ksize=(1, 1), stride=1, pad=0, out_hw=None,
            lo=0.0, rne=False, res=None, res_scale=0.0, res_mode="fma"):
    """int8 convolution + fused requant (module docs). Returns (N, Ho, Wo,
    Cout) int8.

    A CUDA `x` launches the kernel on the current stream (and counts it in
    `conv_s8.launches`); a CPU `x` runs the plain version; any other device
    raises, as does anything the kernel does not take.
    """
    ksize = tuple(ksize)
    dims = _check(x, w, mult, bias, ksize, stride, pad, out_hw, res, res_mode)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_s8 runs on cuda or cpu, not {x.device}")
    if x.device.type == "cpu":
        return conv_s8_reference(x, w, mult, bias, ksize, stride, pad,
                                 dims[4:6], lo, rne, res, res_scale, res_mode)
    out = _launch(x, w, mult, bias, res, dims, ksize, stride, pad, lo, rne,
                  res_scale, res_mode)
    conv_s8.launches += 1
    return out


conv_s8.launches = 0

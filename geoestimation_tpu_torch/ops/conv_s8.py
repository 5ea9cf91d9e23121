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
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

# What the kernel takes (checked again by its C entry point): its output
# pixel indexes and K are int32 (a block of 128 pixels past the last one
# included); its byte offsets are 64-bit, so activations may pass 2 GiB.
CIN_MULTIPLE = 16
COUT_MULTIPLE = 8
MAX_PIXELS = 2 ** 31 - 128      # N * Ho * Wo, exclusive
MAX_WEIGHTS = 2 ** 31           # KH * KW * Cin * Cout, exclusive


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


def _launch(x, w, mult, bias, res, dims, ksize, stride, pad, lo, rne,
            res_scale, res_mode):
    n, h, wd, cin, ho, wo, cout = dims
    if cin % CIN_MULTIPLE or cout % COUT_MULTIPLE:
        raise ValueError(
            f"the CUDA kernel takes Cin % {CIN_MULTIPLE} == 0 and Cout % "
            f"{COUT_MULTIPLE} == 0; got {cin}, {cout}")
    if n * ho * wo >= MAX_PIXELS or ksize[0] * ksize[1] * cin * cout >= \
            MAX_WEIGHTS:
        raise ValueError(
            f"the CUDA kernel takes N*Ho*Wo < {MAX_PIXELS} and KH*KW*Cin*Cout "
            f"< {MAX_WEIGHTS}; got {n * ho * wo} and "
            f"{ksize[0] * ksize[1] * cin * cout}")
    if any(t is not None and t.data_ptr() % 16
           for t in (x, w, mult, bias, res)):
        raise ValueError("the CUDA kernel needs 16-byte aligned tensors")
    lib = _build.load("conv_s8")
    fn = lib.geo_conv_s8
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    out = torch.empty((n, ho, wo, cout), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), mult.data_ptr(), bias.data_ptr(),
                 None if res is None else res.data_ptr(), out.data_ptr(),
                 n, h, wd, cin, ho, wo, cout, ksize[0], ksize[1], stride, pad,
                 float(lo), int(rne), 0 if res is None else RES_MODES[res_mode],
                 float(res_scale), stream)
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

"""Fused stride-1 ResNet bottleneck (inference): the CUDA kernel's wrapper,
its plain PyTorch version, and BatchNorm folding.

The kernel (`csrc/fused_bottleneck.cu`) replaces the Pallas TPU kernel
`geoestimation_tpu/ops/fused_bottleneck.py::fused_bottleneck`: the whole
block -- 1x1 conv, 3x3 conv, 1x1 conv, residual, relu -- in one pass, with
y1 and y2 kept in shared memory. Its source says what bounds it on the H100
and what the design does about that.

Layouts: activations NHWC; weights out-channel major with the input channels
contiguous, which is torch's OIHW with the 1x1 taps squeezed and the 3x3
kernel as (out, dy, dx, in):
  x  (N, H, W, Cin) bf16     w1 (Cmid, Cin) bf16        b1 (Cmid,) f32
  w2 (Cmid, 3, 3, Cmid) bf16 b2 (Cmid,) f32
  w3 (Cout, Cmid) bf16       b3 (Cout,) f32
  wd (Cout, Cin) bf16        bd (Cout,) f32   (projection; None for identity)
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# What the kernel takes (checked again by its C entry point).
CIN_MULTIPLE = 16
CMID_COUT_MULTIPLE = 64


def fold_bn(kernel, bn_scale, bn_bias, bn_mean, bn_var, eps=1e-5):
    """Fold BatchNorm(scale, bias, mean, var) into an OIHW conv kernel + bias.

    conv(x, W) then BN == conv(x, W * g) + (bias - mean * g),
    g = scale / sqrt(var + eps), broadcast over the output-channel (first)
    axis. float32 in, float32 out, the same operations as the JAX fold.
    """
    g = bn_scale / torch.sqrt(bn_var + eps)
    folded_kernel = kernel * g.reshape((-1,) + (1,) * (kernel.dim() - 1))
    folded_bias = bn_bias - bn_mean * g
    return folded_kernel, folded_bias


def fused_bottleneck_reference(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None):
    """Plain PyTorch version of the kernel: the same products in float32 on
    the bf16 values, rounded to bf16 at the same points (y1, y2, out)."""
    h, w = x.shape[1], x.shape[2]
    xf = x.float()
    y1 = torch.relu(xf @ w1.float().t() + b1).to(torch.bfloat16)
    y1p = torch.nn.functional.pad(y1.float(), (0, 0, 1, 1, 1, 1))
    w2f = w2.float()
    acc = torch.zeros(x.shape[:3] + (w2.shape[0],), dtype=torch.float32,
                      device=x.device)
    for dx in range(3):
        for dy in range(3):
            acc += y1p[:, dy:dy + h, dx:dx + w, :] @ w2f[:, dy, dx, :].t()
    y2 = torch.relu(acc + b2).to(torch.bfloat16)
    y3 = y2.float() @ w3.float().t() + b3
    res = xf if wd is None else xf @ wd.float().t() + bd
    return torch.relu(y3 + res).to(torch.bfloat16)


def _check(x, w1, b1, w2, b2, w3, b3, wd, bd):
    if (wd is None) != (bd is None):
        raise ValueError("wd and bd come together")
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, Cin); got shape {tuple(x.shape)}")
    n, h, w, cin = x.shape
    cmid, cout = w1.shape[0], w3.shape[0]
    shapes = {"x": (x, (n, h, w, cin)), "w1": (w1, (cmid, cin)),
              "b1": (b1, (cmid,)), "w2": (w2, (cmid, 3, 3, cmid)),
              "b2": (b2, (cmid,)), "w3": (w3, (cout, cmid)),
              "b3": (b3, (cout,))}
    if wd is not None:
        shapes.update(wd=(wd, (cout, cin)), bd=(bd, (cout,)))
    elif cin != cout:
        raise ValueError(f"identity residual needs Cin == Cout; got {cin} "
                         f"-> {cout}")
    for name, (t, shape) in shapes.items():
        want = torch.float32 if name.startswith("b") else torch.bfloat16
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}; got "
                             f"{tuple(t.shape)}")
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}; got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n, h, w, cin, cmid, cout


def _launch(x, w1, b1, w2, b2, w3, b3, wd, bd, dims):
    n, h, w, cin, cmid, cout = dims
    if cin % CIN_MULTIPLE or cmid % CMID_COUT_MULTIPLE \
            or cout % CMID_COUT_MULTIPLE:
        raise ValueError(
            f"the CUDA kernel takes Cin % {CIN_MULTIPLE} == 0 and Cmid, Cout "
            f"% {CMID_COUT_MULTIPLE} == 0; got {cin}, {cmid}, {cout}")
    tensors = [x, w1, b1, w2, b2, w3, b3] + ([wd, bd] if wd is not None
                                             else [])
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the CUDA kernel needs 16-byte aligned tensors")
    lib = _build.load("fused_bottleneck")
    fn = lib.geo_fused_bottleneck
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((n, h, w, cout), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                 b2.data_ptr(), w3.data_ptr(), b3.data_ptr(),
                 None if wd is None else wd.data_ptr(),
                 None if bd is None else bd.data_ptr(), out.data_ptr(),
                 n, h, w, cin, cmid, cout, stream)
    if err:
        raise RuntimeError(f"fused_bottleneck CUDA kernel failed to launch: "
                           f"cudaError {err}")
    fused_bottleneck.launches += 1
    return out


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None):
    """relu(conv3(relu(conv2(relu(conv1(x))))) + residual), stride 1.

    A CUDA `x` launches the kernel on the current stream (and counts it in
    `fused_bottleneck.launches`); a CPU `x` runs the plain version. Anything
    the kernel does not take raises. Returns (N, H, W, Cout) bf16.
    """
    dims = _check(x, w1, b1, w2, b2, w3, b3, wd, bd)
    if x.device.type == "cpu":
        return fused_bottleneck_reference(x, w1, b1, w2, b2, w3, b3, wd, bd)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck runs on cuda or cpu, not "
                         f"{x.device}")
    return _launch(x, w1, b1, w2, b2, w3, b3, wd, bd, dims)


fused_bottleneck.launches = 0

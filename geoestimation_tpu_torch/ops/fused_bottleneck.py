"""Fused ResNet bottlenecks (inference): the CUDA kernels' wrappers, their
plain PyTorch versions, and BatchNorm folding.

Two kernels, each replacing a Pallas TPU kernel of
`geoestimation_tpu/ops/fused_bottleneck.py` and computing the whole block --
1x1 conv, 3x3 conv, 1x1 conv, residual, relu -- in one pass, with y1 and y2
kept in shared memory:
  * `fused_bottleneck` (`csrc/fused_bottleneck.cu`): stride 1, identity or
    1x1 projection residual;
  * `fused_bottleneck_s2` (`csrc/fused_bottleneck_s2.cu`): the stride-2
    stage entry, 3x3 conv and 1x1 projection at stride 2.
Each source says what bounds it on the H100 and what the design does about
that.

Layouts: activations NHWC; weights out-channel major with the input channels
contiguous, which is torch's OIHW with the 1x1 taps squeezed and the 3x3
kernel as (out, dy, dx, in):
  x  (N, H, W, Cin) bf16     w1 (Cmid, Cin) bf16        b1 (Cmid,) f32
  w2 (Cmid, 3, 3, Cmid) bf16 b2 (Cmid,) f32
  w3 (Cout, Cmid) bf16       b3 (Cout,) f32
  wd (Cout, Cin) bf16        bd (Cout,) f32   (projection; None for identity)
The stride-2 block returns (N, H/2, W/2, Cout).
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


def _launch(kernel, tensors, dims, out_hw):
    """Launches `csrc/<kernel>.cu` on the current stream; `tensors` are x,
    w1, b1, w2, b2, w3, b3, wd, bd (wd, bd None for the identity residual)."""
    n, h, w, cin, cmid, cout = dims
    if cin % CIN_MULTIPLE or cmid % CMID_COUT_MULTIPLE \
            or cout % CMID_COUT_MULTIPLE:
        raise ValueError(
            f"the CUDA kernel takes Cin % {CIN_MULTIPLE} == 0 and Cmid, Cout "
            f"% {CMID_COUT_MULTIPLE} == 0; got {cin}, {cmid}, {cout}")
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError("the CUDA kernel needs 16-byte aligned tensors")
    fn = getattr(_build.load(kernel), f"geo_{kernel}")
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    x = tensors[0]
    out = torch.empty((n, *out_hw, cout), dtype=torch.bfloat16,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(None if t is None else t.data_ptr() for t in tensors),
                 out.data_ptr(), n, h, w, cin, cmid, cout, stream)
    if err:
        raise RuntimeError(f"{kernel} CUDA kernel failed to launch: "
                           f"cudaError {err}")
    return out


def kernel_plan(kernel, n, h, w, cin, cmid, cout, proj):
    """What `csrc/<kernel>.cu` chooses for a shape, from its C query (card
    only): {"smem_bytes", "blocks_per_sm", "th", "stages", "tw"}, TH and TW
    being the output rows and columns of a work item."""
    fn = getattr(_build.load(kernel), f"geo_{kernel}_plan")
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    err = fn(n, h, w, cin, cmid, cout, int(proj), out)
    if err:
        raise RuntimeError(f"{kernel} plan query failed: cudaError {err}")
    return dict(zip(("smem_bytes", "blocks_per_sm", "th", "stages", "tw"),
                    out))


def _on_cpu(x, name):
    """True for a CPU `x` (the plain version runs), False for a CUDA one
    (the kernel launches); any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return x.device.type == "cpu"


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None):
    """relu(conv3(relu(conv2(relu(conv1(x))))) + residual), stride 1.

    A CUDA `x` launches the kernel on the current stream (and counts it in
    `fused_bottleneck.launches`); a CPU `x` runs the plain version. Anything
    the kernel does not take raises. Returns (N, H, W, Cout) bf16.
    """
    args = (x, w1, b1, w2, b2, w3, b3, wd, bd)
    dims = _check(*args)
    if _on_cpu(x, "fused_bottleneck"):
        return fused_bottleneck_reference(*args)
    out = _launch("fused_bottleneck", args, dims, dims[1:3])
    fused_bottleneck.launches += 1
    return out


fused_bottleneck.launches = 0


def fused_bottleneck_s2_reference(x, w1, b1, w2, b2, w3, b3, wd, bd):
    """Plain PyTorch version of the stride-2 kernel: the same products in
    float32 on the bf16 values, the taps summed in the Pallas kernel's order
    (dy, then dx), rounded to bf16 at the same points (y1, y2, out)."""
    h2, w2_ = x.shape[1] // 2, x.shape[2] // 2
    xf = x.float()
    y1 = torch.relu(xf @ w1.float().t() + b1).to(torch.bfloat16)
    # zero row and column -1; for even H and W the far edges are never read
    y1p = torch.nn.functional.pad(y1.float(), (0, 0, 1, 0, 1, 0))
    w2f = w2.float()
    acc = torch.zeros((x.shape[0], h2, w2_, w2.shape[0]), dtype=torch.float32,
                      device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc += (y1p[:, dy:dy + 2 * h2:2, dx:dx + 2 * w2_:2, :]
                    @ w2f[:, dy, dx, :].t())
    y2 = torch.relu(acc + b2).to(torch.bfloat16)
    y3 = y2.float() @ w3.float().t() + b3
    res = xf[:, ::2, ::2, :] @ wd.float().t() + bd
    return torch.relu(y3 + res).to(torch.bfloat16)


def fused_bottleneck_s2(x, w1, b1, w2, b2, w3, b3, wd, bd):
    """The stride-2 stage-entry block: relu(conv3(relu(conv2_s2(relu(
    conv1(x))))) + proj_s2(x)), with the 3x3 conv and the 1x1 projection at
    stride 2. The projection (wd, bd) is required; H and W must be even.

    A CUDA `x` launches the kernel on the current stream (and counts it in
    `fused_bottleneck_s2.launches`); a CPU `x` runs the plain version.
    Anything the kernel does not take raises. Returns (N, H/2, W/2, Cout)
    bf16.
    """
    if wd is None or bd is None:
        raise ValueError("the stride-2 block needs its projection: wd and bd "
                         "are required")
    args = (x, w1, b1, w2, b2, w3, b3, wd, bd)
    dims = _check(*args)
    n, h, w = dims[:3]
    if h % 2 or w % 2:
        raise ValueError(f"the stride-2 block needs even H and W; got {h}x{w}")
    if _on_cpu(x, "fused_bottleneck_s2"):
        return fused_bottleneck_s2_reference(*args)
    out = _launch("fused_bottleneck_s2", args, dims, (h // 2, w // 2))
    fused_bottleneck_s2.launches += 1
    return out


fused_bottleneck_s2.launches = 0

"""The epilogue of the fast path's bf16 convolutions: bias, relu and residual
add in one pass over the convolution's output, in place. The CUDA kernel's
wrapper (`csrc/conv_epilogue.cu`) and its plain PyTorch version.

  bias_relu_(y, b)                 y = relu(bf16(y + b))
  bias_add_relu_(y, b, res)        y = relu(bf16(bf16(y + b) + res))
  bias_add_relu_(y, b, res, bres)  the same with the residual bf16(res + bres)

`y` is a convolution's fresh (N, C, H, W) bf16 output, `b` and `bres` its
and the downsample's bf16 biases (C elements, as (C,) or (C, 1, 1)), `res`
the block's input or the downsample convolution's raw output. Each add is
PyTorch's add of two bf16 tensors (a float32 sum rounded to nearest even)
and relu is `torch.relu`, so the kernel's bits are those of the plain
version, which is the composition of those operators.

A CUDA `y` launches the kernel on the current stream and needs channels-last
maps with C a multiple of 8; each launch counts in `launches` here and,
while a profiler records, in the counter `conv_epilogue.launches`. A CPU `y`
runs the plain version; any other device raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import spans
from . import _build

BIAS_RELU, BIAS_ADD_RELU, BIAS_ADD_RELU_DS = 0, 1, 2
VEC = 8                          # bf16 channels in 16 bytes, as the kernel

launches = 0


# -- the plain version --------------------------------------------------------

def bias_relu_reference(y, b):
    """relu(y + b) written into y."""
    return torch.relu_(y.add_(b))


def bias_add_relu_reference(y, b, res, bres=None):
    """relu((y + b) + r) written into y, r = res or res + bres."""
    return torch.relu_(y.add_(b).add_(res if bres is None else res + bres))


# -- the kernel ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, built and loaded at first use."""
    fn = _build.load("conv_epilogue").geo_conv_epilogue
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_map(name, t, like=None):
    if t.dim() != 4 or not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"conv_epilogue: {name} must be a channels-last (N, "
                         f"C, H, W) map; got shape {tuple(t.shape)}, strides "
                         f"{t.stride()}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"conv_epilogue: {name} must be bfloat16; got "
                        f"{t.dtype}")
    if like is not None and (t.shape != like.shape
                             or t.device != like.device):
        raise ValueError(f"conv_epilogue: {name} must match y: "
                         f"{tuple(t.shape)} {t.device}")
    if t.data_ptr() % 16:
        raise ValueError(f"conv_epilogue: {name} must be 16-byte aligned")


def _check_bias(name, t, y):
    c = y.shape[1]
    if t.dtype != torch.bfloat16 or t.numel() != c or not t.is_contiguous() \
            or t.device != y.device:
        raise ValueError(f"conv_epilogue: {name} must be {c} contiguous "
                         f"bfloat16 values on {y.device}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    if t.data_ptr() % 16:
        raise ValueError(f"conv_epilogue: {name} must be 16-byte aligned")


def _launch(form, y, b, res=None, bres=None):
    """Launches the kernel on y in place; returns y."""
    global launches
    if y.device.index != torch.cuda.current_device():
        with torch.cuda.device(y.device):
            return _launch(form, y, b, res, bres)
    _check_map("y", y)
    c = y.shape[1]
    if c % VEC:
        raise ValueError(f"conv_epilogue: the kernel takes C a multiple of "
                         f"{VEC}; got C = {c}")
    _check_bias("b", b, y)
    if res is not None:
        _check_map("res", res, y)
        if res.data_ptr() == y.data_ptr():
            raise ValueError("conv_epilogue: res must not be y")
    if bres is not None:
        _check_bias("bres", bres, y)
    err = _entry()(form, y.data_ptr(), b.data_ptr(),
                   None if res is None else res.data_ptr(),
                   None if bres is None else bres.data_ptr(),
                   y.numel() // c, c, _sms(y.device.index),
                   torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"conv_epilogue: the kernel failed to launch: "
                           f"cudaError {err}")
    launches += 1
    spans.count("conv_epilogue.launches")
    return y


def _on_cpu(y):
    """True for a CPU y (the plain version runs), False for a CUDA one (the
    kernel launches); any other device raises."""
    if y.is_cuda or y.is_cpu:
        return y.is_cpu
    raise ValueError(f"conv_epilogue runs on cuda or cpu, not {y.device}")


# -- by device ----------------------------------------------------------------

def bias_relu_(y, b):
    """y = relu(bf16(y + b)), in place; returns y."""
    if _on_cpu(y):
        return bias_relu_reference(y, b)
    return _launch(BIAS_RELU, y, b)


def bias_add_relu_(y, b, res, bres=None):
    """y = relu(bf16(bf16(y + b) + r)), in place, r = res for an identity
    residual and bf16(res + bres) for a downsample's raw output; returns
    y."""
    if _on_cpu(y):
        return bias_add_relu_reference(y, b, res, bres)
    return _launch(BIAS_ADD_RELU if bres is None else BIAS_ADD_RELU_DS, y, b,
                   res, bres)

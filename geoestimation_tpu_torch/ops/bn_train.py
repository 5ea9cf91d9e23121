"""Train-mode BatchNorm fused with the relu and residual add after it: the
CUDA kernels' wrapper (`csrc/bn_train.cu`), their plain PyTorch version, and
the autograd Function the ResNet's train mode calls.

`bn_train(x, weight, bias, eps, relu, residual)` is flax's train-mode
BatchNorm as the JAX model rounds it: the batch's float32 mean and biased
"fast" variance E[x^2] - E[x]^2 clipped at 0, y = ((x - mean) * (rsqrt(var
+ eps) * weight)) + bias in float32, rounded to x's dtype; then relu(y), or
relu(y + residual) with the add in x's dtype. It returns (out, mean, var),
the float32 statistics for the running ones. Four steps, each a kernel on
the card and a plain version here:

  1. `stats`: per-channel sum of x and of x^2, and the element count; the
     caller sums them over the data axis (`multihost.sum_over_ranks`);
  2. `apply`: the statistics from the sums, then the normalisation, relu
     and residual;
  3. `bwd_reduce`: g = dy where out > 0 (dy in the plain form), the
     per-channel sums of g and of g * (x - mean) from the saved input, and
     from them the bias's and weight's gradients (the rank's own sums of g
     and of g * xh, xh = (x - mean) * rstd) and d1, d2, the gradients with
     respect to the sums of x and of x^2, which `multihost.sum_bn_grads`
     sums over the data axis;
  4. `bwd_dx`: dx = (g * rstd * weight + d2 * 2x) + d1.

That is the analytic gradient weight * rstd * (g - sum g / M - xh * sum
(g xh) / M), the variance's term dropped for a channel whose variance was
clipped, in autodiff's arrangement: on the CPU the plain version takes
autodiff's own steps, bit for bit those of the formula's autograd, so that
the CPU tests' float32 train steps, which cross ReLU kinks at their
tolerances, keep their bits. Saved for the backward: x, out (relu forms),
the sums and the weight; no float32 copy of a map.

A CUDA x launches the kernels on the current stream and needs channels-last
memory (`dy` is made so where it is not: the global pool's expanded
gradient); a CPU x runs the plain version, in float32 (float64 for a
float64 x); any other device raises.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ..parallel import multihost
from ..utils import spans
from . import _build

PLAIN, RELU, ADD_RELU = 0, 1, 2
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_PACK = {torch.bfloat16: 8, torch.float32: 4}    # channels in 16 bytes
_MAX_TILES = 64                                  # as csrc/bn_train.cu


# -- the plain version --------------------------------------------------------

def _compute(x):
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _per_channel(v):
    return v[:, None, None]


def stats_reference(x):
    """(2C + 1,) sums: of x, of x^2 per channel, and the element count."""
    xf = _compute(x)
    c = x.shape[1]
    return torch.cat([xf.sum(dim=(0, 2, 3)), xf.square().sum(dim=(0, 2, 3)),
                      xf.new_full((1,), x.numel() // c)])


def channel_stats(sums, eps):
    """(mean, var, rstd, keep) per channel from the sums: var clipped at 0,
    keep False where the clip engaged."""
    c = (sums.numel() - 1) // 2
    mean = sums[:c] / sums[-1]
    raw = sums[c:2 * c] / sums[-1] - mean.square()
    var = torch.clamp(raw, min=0)
    return mean, var, torch.rsqrt(var + eps), raw >= 0


def apply_reference(x, sums, weight, bias, eps, form, residual=None):
    """(out, mean, var) of step 2."""
    mean, var, rstd, _ = channel_stats(sums, eps)
    mul = rstd * weight
    y = ((_compute(x) - _per_channel(mean)) * _per_channel(mul)
         + _per_channel(bias)).to(x.dtype)
    if form == ADD_RELU:
        y = y + residual
    return (y if form == PLAIN else torch.relu(y)), mean, var


def _g(dy, out, form):
    """dy where out > 0 (dy itself in the plain form), in the compute
    type."""
    g = dy if form == PLAIN else torch.where(out > 0, dy, torch.zeros_like(dy))
    return _compute(g)


def bwd_reduce_reference(dy, out, x, sums, weight, eps, form):
    """(4, C) of step 3, the rank's own: the bias's and the weight's
    gradients, and the gradients with respect to the sums of x and of x^2
    (d1, d2), each operation as autodiff of the forward's formula does it."""
    mean, _, rstd, keep = channel_stats(sums, eps)
    mul = rstd * weight
    g = _g(dy, out, form)
    dmul = (g * (_compute(x) - _per_channel(mean))).sum(dim=(0, 2, 3))
    # rsqrt's backward, then the clip's
    dvar = torch.where(keep, -0.5 * (dmul * weight) * rstd.pow(3),
                       torch.zeros_like(rstd))
    dmean = (-(g * _per_channel(mul))).sum(dim=(0, 2, 3)) + (-dvar) * (
        2 * mean)
    return torch.stack([g.sum(dim=(0, 2, 3)), dmul * rstd, dmean / sums[-1],
                        dvar / sums[-1]])


def bwd_dx_reference(dy, out, x, sums, weight, d12, eps, form):
    """(dx, the residual's gradient or None) of step 4, `d12` the (2, C) d1
    and d2 of step 3 summed over the ranks: dx = (g * mul + d2 * 2x) + d1,
    the terms of the normalisation, of the sum of x^2 and of the sum of x,
    added in the order autodiff adds them."""
    _, _, rstd, _ = channel_stats(sums, eps)
    xf = _compute(x)
    dx = (_g(dy, out, form) * _per_channel(rstd * weight)
          + _per_channel(d12[1]) * (2 * xf)) + _per_channel(d12[0])
    g = None if form != ADD_RELU else torch.where(out > 0, dy,
                                                  torch.zeros_like(dy))
    return dx.to(x.dtype), g


# -- the kernels --------------------------------------------------------------

_fns = None
_grids: dict = {}
_scratch: dict = {}


def _lib():
    """The C entry points of csrc/bn_train.cu, their argument types set."""
    global _fns
    if _fns is None:
        lib = _build.load("bn_train")
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        types = {
            "geo_bn_grid": [i, ll, i, ctypes.POINTER(ctypes.c_int)],
            "geo_bn_stats": [i, p, ll, i, p, p, p, p],
            "geo_bn_apply": [i, i, p, p, p, p, p, f, ll, i, p, p, p, p],
            "geo_bn_bwd_reduce": [i, i, p, p, p, p, p, f, ll, i, p, p, p, p],
            "geo_bn_bwd_dx": [i, i, p, p, p, p, p, p, f, ll, i, p, p, p],
        }
        fns = {}
        for name, argtypes in types.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[name] = fn
        _fns = fns
    return _fns


def _check_map(name, t, like=None):
    if t.dim() != 4 or not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"bn_train: {name} must be a channels-last (N, C, "
                         f"H, W) map; got shape {tuple(t.shape)}, strides "
                         f"{t.stride()}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"bn_train: {name} must be bfloat16 or float32; got "
                        f"{t.dtype}")
    if like is not None and (t.shape != like.shape or t.dtype != like.dtype
                             or t.device != like.device):
        raise ValueError(f"bn_train: {name} must match x: {tuple(t.shape)} "
                         f"{t.dtype} {t.device}")
    if t.data_ptr() % 16:
        raise ValueError(f"bn_train: {name} must be 16-byte aligned")


def _geometry(x):
    """(dtype code, rows, channels, row blocks of a reduction, bytes of one
    map) of the kernels for x, the grid asked of the library once for each
    shape and card."""
    _check_map("x", x)
    c = x.shape[1]
    rows = x.numel() // c
    key = (x.dtype, rows, c, x.get_device())
    if key not in _grids:
        pack = _PACK[x.dtype]
        if c % pack or (c // pack <= 32 and 32 % (c // pack)) or (
                c // pack > 32 and (c // pack) % 32) or c // (32 * pack) > \
                _MAX_TILES:
            raise ValueError(f"bn_train: the kernels take C a multiple of "
                             f"{pack} with C / {pack} dividing 32 or a "
                             f"multiple of 32; got C = {c}")
        grid = (ctypes.c_int * 2)()
        err = _lib()["geo_bn_grid"](_DTYPES[x.dtype], rows, c, grid)
        if err:
            raise RuntimeError(f"bn_train: grid query failed: cudaError "
                               f"{err}")
        _grids[key] = (_DTYPES[x.dtype], rows, c, grid[1],
                       x.numel() * x.element_size())
    return _grids[key]


def _stream(x, partials=0):
    """(ticket counters, partials buffer, stream) for the current stream of
    x's card: one zeroed set of counters and one buffer of at least
    `partials` floats a stream, shared by every launch on it (the stream
    orders them; each reduction leaves its counters zeroed)."""
    card = x.get_device()
    stream = torch._C._cuda_getCurrentRawStream(card)
    entry = _scratch.get((card, stream))
    if entry is None or entry[1].numel() < partials:
        counters = entry[0] if entry is not None else torch.zeros(
            _MAX_TILES, dtype=torch.int32, device=x.device)
        entry = _scratch[card, stream] = (counters, torch.empty(
            max(partials, 1), dtype=torch.float32, device=x.device))
    return entry[0].data_ptr(), entry[1].data_ptr(), stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(kernel, nbytes, *args):
    """Launches `kernel`, counting it and the bytes of the maps it reads
    and writes."""
    err = _fns[kernel](*args)
    if err:
        raise RuntimeError(f"bn_train: {kernel} failed to launch: cudaError "
                           f"{err}")
    bn_train.launches += 1
    bn_train.bytes += nbytes
    spans.count("bn_train.launches")


def stats(x):
    """Step 1 on the card: (2C + 1,) float32 sums."""
    dtype, rows, c, gy, nbytes = _geometry(x)
    sums = torch.empty(2 * c + 1, dtype=torch.float32, device=x.device)
    counters, part, stream = _stream(x, gy * 2 * c)
    _launch("geo_bn_stats", nbytes, dtype, x.data_ptr(), rows, c, part,
            counters, sums.data_ptr(), stream)
    return sums


def apply(x, sums, weight, bias, eps, form, residual=None):
    """Step 2 on the card: (out, mean, var)."""
    dtype, rows, c, _, nbytes = _geometry(x)
    if form == ADD_RELU:
        _check_map("residual", residual, x)
    out = torch.empty_like(x, memory_format=torch.channels_last)
    stat = torch.empty(2 * c, dtype=torch.float32, device=x.device)
    mean, var = stat[:c], stat[c:]
    _, _, stream = _stream(x)
    _launch("geo_bn_apply", (2 + (form == ADD_RELU)) * nbytes, dtype, form,
            x.data_ptr(), _ptr(residual), sums.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), eps, rows, c, out.data_ptr(), mean.data_ptr(),
            var.data_ptr(), stream)
    return out, mean, var


def bwd_reduce(dy, out, x, sums, weight, eps, form):
    """Step 3 on the card: (4, C) float32."""
    dtype, rows, c, gy, nbytes = _geometry(x)
    _check_map("dy", dy, x)
    if form != PLAIN:
        _check_map("out", out, x)
    red = torch.empty((4, c), dtype=torch.float32, device=x.device)
    counters, part, stream = _stream(x, gy * 2 * c)
    _launch("geo_bn_bwd_reduce", (2 + (form != PLAIN)) * nbytes, dtype, form,
            dy.data_ptr(), _ptr(out), x.data_ptr(), sums.data_ptr(),
            weight.data_ptr(), eps, rows, c, part, counters, red.data_ptr(),
            stream)
    return red


def bwd_dx(dy, out, x, sums, weight, d12, eps, form):
    """Step 4 on the card: (dx, the residual's gradient or None); `d12`
    (2, C)."""
    dtype, rows, c, _, nbytes = _geometry(x)
    _check_map("dy", dy, x)
    if form != PLAIN:
        _check_map("out", out, x)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dres = (torch.empty_like(x, memory_format=torch.channels_last)
            if form == ADD_RELU else None)
    d12 = d12.contiguous()
    _, _, stream = _stream(x)
    _launch("geo_bn_bwd_dx",
            (3 + (form != PLAIN) + (form == ADD_RELU)) * nbytes, dtype, form,
            dy.data_ptr(), _ptr(out), x.data_ptr(), sums.data_ptr(),
            weight.data_ptr(), d12.data_ptr(), eps, rows, c, dx.data_ptr(),
            _ptr(dres), stream)
    return dx, dres


# -- by device ----------------------------------------------------------------

def _on_cpu(x):
    """True for a CPU x (the plain version runs), False for a CUDA one (the
    kernels launch); any other device raises."""
    if x.is_cuda or x.is_cpu:
        return x.is_cpu
    raise ValueError(f"bn_train runs on cuda or cpu, not {x.device}")


class _BatchNormTrain(torch.autograd.Function):
    """(out, mean, var) of `bn_train`; mean and var are not
    differentiable."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, eps, form):
        if _on_cpu(x):
            sums = multihost.sum_over_ranks(stats_reference(x))
            out, mean, var = apply_reference(x, sums, weight, bias, eps, form,
                                             residual)
        else:
            with torch.cuda.device(x.get_device()):
                sums = multihost.sum_over_ranks(stats(x))
                out, mean, var = apply(x, sums, weight, bias, eps, form,
                                       residual)
        ctx.eps, ctx.form = eps, form
        ctx.save_for_backward(x, None if form == PLAIN else out, sums, weight)
        ctx.mark_non_differentiable(mean, var)
        # the backward ignores mean's and var's gradients: no zeros made
        # and filled for them on every step
        ctx.set_materialize_grads(False)
        return out, mean, var

    @staticmethod
    @once_differentiable
    def backward(ctx, dout, _dmean, _dvar):
        x, out, sums, weight = ctx.saved_tensors
        eps, form = ctx.eps, ctx.form
        if _on_cpu(x):
            red = bwd_reduce_reference(dout, out, x, sums, weight, eps, form)
            dx, dres = bwd_dx_reference(dout, out, x, sums, weight,
                                        multihost.sum_bn_grads(red[2:]), eps,
                                        form)
        else:
            if not dout.is_contiguous(memory_format=torch.channels_last):
                dout = dout.contiguous(memory_format=torch.channels_last)
            with torch.cuda.device(x.get_device()):
                red = bwd_reduce(dout, out, x, sums, weight, eps, form)
                dx, dres = bwd_dx(dout, out, x, sums, weight,
                                  multihost.sum_bn_grads(red[2:]), eps, form)
        return dx, red[1], red[0], dres, None, None


def bn_train(x, weight, bias, eps, relu=False, residual=None):
    """(out, mean, var): flax's train-mode BatchNorm of the (N, C, H, W) x
    with float32 weight and bias, then relu where `relu`, or relu(y +
    residual) where a residual of x's shape and dtype is given (it needs
    relu). Counts each kernel launch in `bn_train.launches` (4 a BatchNorm
    and step) and, while a profiler records, in the counter
    `bn_train.launches` too; and the bytes of the maps the kernels read and
    write in `bn_train.bytes` (`tools/train_roofline.py` adds them to the
    operators' bytes)."""
    if residual is not None and not relu:
        raise ValueError("bn_train: the residual form is relu(y + residual); "
                         "it needs relu=True")
    form = ADD_RELU if residual is not None else RELU if relu else PLAIN
    return _BatchNormTrain.apply(x, weight, bias, residual, eps, form)


bn_train.launches = 0
bn_train.bytes = 0

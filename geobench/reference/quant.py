"""Rounding to a lower precision than the configuration states, for the
control: the reference put in the program's place at the precision that
would tempt a later change. Weights are scaled per output channel, and
activations per sample, by their largest magnitude.

  int4: symmetric integers in [-7, 7] (below the int8 configuration);
  fp8:  float8 e4m3 (below the bf16 configuration).

Training below bf16 is fp8 training (`fp8_training`): each convolution's
and matrix product's inputs and weights in e4m3 and the gradient of its
output in e5m2, as Transformer Engine's recipe computes them, and every
activation that bf16 training holds between operations in e4m3; each
tensor scaled by its own largest magnitude, products and normalization
in float32."""

from __future__ import annotations

import torch

FP8_MAX = 448.0
E5M2_MAX = 57344.0


def _amax(t, kind):
    dims = tuple(range(1, t.dim()))
    return t.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12)


def int4(t, kind):
    s = _amax(t, kind) / 7.0
    return torch.clamp(torch.round(t / s), -7, 7) * s


def fp8(t, kind):
    s = _amax(t, kind) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s


def _per_tensor(t, dtype, top):
    s = t.abs().amax().clamp_min(1e-30) / top
    return (t / s).to(dtype).to(t.dtype) * s


class _GradE5M2(torch.autograd.Function):
    """The identity, whose gradient is rounded to e5m2."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _per_tensor(g, torch.float8_e5m2, E5M2_MAX)


def fp8_training(t, kind):
    """kind "act" or "weight": t rounded to e4m3 (the gradient passes the
    rounding unchanged); kind "grad" (a product's output): t, its gradient
    rounded to e5m2."""
    if kind == "grad":
        return _GradE5M2.apply(t)
    r = _per_tensor(t.detach(), torch.float8_e4m3fn, FP8_MAX)
    return t + (r - t.detach())


CONTROLS = {"int8": int4, "bf16": fp8}
TRAINING_CONTROLS = {"bf16": fp8_training}

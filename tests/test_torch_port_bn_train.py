"""The train-mode BatchNorm Function (`ops/bn_train.py`) on its plain path,
on the CPU: its forward equals the JAX model's formula as the port wrote it
before the Function (statistics, normalisation, then relu or the residual
add in the map's dtype), bit for bit; its backward equals autograd of that
formula in float64 for every form, a clipped variance included, and bit for
bit in bf16 and float32."""

import numpy as np
import pytest
import torch

from geoestimation_tpu_torch.ops import bn_train as ops_bn
from tests.torch_port_world import one_thread_no_tensorboard  # noqa: F401

EPS = 1e-5


def formula(x, weight, bias, relu, residual):
    """The train-mode BatchNorm as a chain of autograd operators: float32
    statistics (float64 for float64), the clipped fast variance, the
    normalisation rounded to x's dtype, the residual added in that dtype,
    relu; (out, mean, var)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    c = x.shape[1]
    sums = torch.cat([xf.sum(dim=(0, 2, 3)), xf.square().sum(dim=(0, 2, 3)),
                      xf.new_full((1,), x.numel() // c)])
    mean, sq = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
    var = torch.clamp(sq - mean.square(), min=0)
    mul = torch.rsqrt(var + EPS) * weight
    y = (xf - mean[:, None, None]) * mul[:, None, None]
    y = (y + bias[:, None, None]).to(x.dtype)
    if residual is not None:
        y = y + residual
    return (torch.relu(y) if relu else y), mean, var


def inputs(dtype, shape=(3, 8, 5, 4), seed=0, clip_channel=None):
    """(x, weight, bias, residual) as channels-last maps and float32 (x's
    float64) parameters; `clip_channel` holds one constant value, whose
    fast variance rounds below 0 in float64 at the default shape."""
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    x = rng.normal(0.3, 1.5, (n, h, w, c))
    if clip_channel is not None:
        x[..., clip_channel] = 0.03
    pdt = torch.float64 if dtype == torch.float64 else torch.float32

    def nchw(a):
        return torch.from_numpy(a).to(dtype).permute(0, 3, 1, 2)

    return (nchw(x), torch.from_numpy(rng.normal(1, 0.3, c)).to(pdt),
            torch.from_numpy(rng.normal(0, 0.3, c)).to(pdt),
            nchw(rng.normal(0, 1, (n, h, w, c))))


FORMS = {"plain": (False, False), "relu": (True, False),
         "residual": (True, True)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_forward_is_the_formula_bit_for_bit(dtype, form):
    relu, with_res = FORMS[form]
    x, weight, bias, res = inputs(dtype)
    res = res if with_res else None
    got = ops_bn.bn_train(x, weight, bias, EPS, relu=relu, residual=res)
    want = formula(x, weight, bias, relu, res)
    assert got[0].dtype == dtype
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _grads(fn, leaves, seed=1):
    """The gradients of sum(out * a seeded cotangent) over `leaves`."""
    out = fn()[0]
    cot = torch.from_numpy(np.random.default_rng(seed).normal(
        0, 1, tuple(out.shape))).to(out.dtype)
    return [torch.zeros_like(t) if g is None else g for t, g in zip(
        leaves, torch.autograd.grad((out * cot).sum(), leaves,
                                    allow_unused=True))]


@pytest.mark.parametrize("case", ["plain", "relu", "identity", "projection",
                                  "clip"])
def test_backward_is_autograd_of_the_formula_in_float64(case):
    """relu: bn1 and bn2; identity: bn3 with the block's input as residual;
    projection: bn3 with the downsample's own plain BatchNorm as residual;
    clip: a constant channel whose fast variance is below 0, where the
    variance term of the gradient drops."""
    f64 = torch.float64
    x, weight, bias, res = inputs(f64, clip_channel=2 if case == "clip"
                                  else None)
    xd, wd, bd, _ = inputs(f64, seed=3)
    keep = ops_bn.channel_stats(ops_bn.stats_reference(x), EPS)[3]
    assert keep.tolist() == [case != "clip" or c != 2 for c in range(8)]
    leaves = [t.requires_grad_() for t in (x, weight, bias, res, xd, wd, bd)]

    def run(bn):
        if case == "plain":
            return bn(x, weight, bias, False, None)
        if case in ("relu", "clip"):
            return bn(x, weight, bias, True, None)
        r = res if case == "identity" else bn(xd, wd, bd, False, None)[0]
        return bn(x, weight, bias, True, r)

    def port(x, w, b, relu, r):
        return ops_bn.bn_train(x, w, b, EPS, relu=relu, residual=r)

    got = _grads(lambda: run(port), leaves)
    want = _grads(lambda: run(formula), leaves)
    used = {"plain": 3, "relu": 3, "clip": 3, "identity": 4,
            "projection": 7}[case]
    for g, w in zip(got[:used], want[:used]):
        torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-12)
    assert all(not g.abs().sum() for g in got[used:])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["plain", "relu", "identity", "clip"])
def test_backward_is_autograd_of_the_formula_bit_for_bit(dtype, case):
    """In bf16 and float32 the plain backward takes autodiff's own steps, so
    the CPU's float32 train steps (held to JAX's across ReLU kinks) keep
    their bits."""
    x, weight, bias, res = inputs(dtype, clip_channel=2 if case == "clip"
                                  else None)
    leaves = [t.requires_grad_() for t in (x, weight, bias, res)]
    relu, r = case != "plain", res if case == "identity" else None

    def port():
        return ops_bn.bn_train(x, weight, bias, EPS, relu=relu, residual=r)

    got = _grads(port, leaves)
    want = _grads(lambda: formula(x, weight, bias, relu, r), leaves)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_statistics_are_not_differentiable_and_other_devices_raise():
    x, weight, bias, _ = inputs(torch.float32)
    x.requires_grad_()
    out, mean, var = ops_bn.bn_train(x, weight, bias, EPS, relu=True)
    assert out.requires_grad and not mean.requires_grad \
        and not var.requires_grad
    with pytest.raises(ValueError, match="needs relu"):
        ops_bn.bn_train(x, weight, bias, EPS, residual=x)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops_bn.bn_train(x.to("meta"), weight.to("meta"), bias.to("meta"), EPS)


def test_train_norms_are_the_forward_s(monkeypatch):
    """`resnet.train_norms` lists the shapes and forms the train-mode
    forward gives `batch_norm_train`, in order."""
    from geoestimation_tpu_torch.models import resnet

    seen, plain = [], resnet.batch_norm_train

    def recording(x, bn, relu=False, residual=None):
        seen.append((tuple(x.shape), "residual" if residual is not None
                     else "relu" if relu else "plain"))
        return plain(x, bn, relu=relu, residual=residual)

    monkeypatch.setattr(resnet, "batch_norm_train", recording)
    model = resnet.build_backbone("resnet14", torch.float32)
    model(torch.zeros(2, 64, 64, 3), train=True)
    assert seen == [(s, f) for _, s, f in resnet.train_norms("resnet14", 2,
                                                             64)]
    r50 = resnet.train_norms("resnet50", 256, 224)
    assert len(r50) == 53 and r50[-1] == ("layer4.2.bn3",
                                          (256, 2048, 7, 7), "residual")

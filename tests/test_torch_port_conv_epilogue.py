"""The fast path's convolution epilogue (`ops/conv_epilogue.py`) on its plain
path, on the CPU: each form, in place, bit for bit the separate bias add,
downsample bias add, residual add and relu that the fast path made before
it, NaN and negative zero included; and the fast network's epilogues by
count (the card's kernel is held to the plain version in
tests/test_torch_port_cuda.py)."""

import numpy as np
import pytest
import torch

from geoestimation_tpu_torch.models import fast_infer as port_fast
from geoestimation_tpu_torch.ops import conv_epilogue as port_epi
from geoestimation_tpu_torch.tools import world
from tests.torch_port_world import one_thread_no_tensorboard  # noqa: F401

FORMS = ["bias_relu", "bias_add_relu", "bias_add_relu_ds"]


def separate_passes(form, y, b, res, bres):
    """The composition the fast path made before the epilogue: bf16 bias add,
    the downsample's bias add, the residual add, relu, each its own
    operator."""
    if form == "bias_relu":
        return torch.relu(y + b)
    r = res if form == "bias_add_relu" else res + bres
    return torch.relu((y + b) + r)


def maps(form, shape=(3, 64, 5, 7), seed=0):
    """(y, b, res, bres): channels-last bf16 maps and (C, 1, 1) biases, with
    NaN, infinities and negative zero planted (channel 0 of every 4th row
    and of the biases holds -0, so that sums of negative zeros reach
    relu)."""
    rng = np.random.default_rng(seed)
    n, c, h, w = shape

    def nchw():
        a = rng.normal(0, 1, (n, h, w, c)).astype(np.float32)
        a.reshape(-1)[::37] = np.nan
        a.reshape(-1)[5::101] = np.inf
        a.reshape(-1)[7::103] = -np.inf
        a.reshape(-1, c)[::4, 0] = -0.0
        return torch.from_numpy(a).to(torch.bfloat16).permute(0, 3, 1, 2)

    def vec():
        v = rng.normal(0, 0.5, c).astype(np.float32)
        v[0] = -0.0
        return torch.from_numpy(v).to(torch.bfloat16)[:, None, None]

    y, b = nchw(), vec()
    res = None if form == "bias_relu" else nchw()
    bres = vec() if form == "bias_add_relu_ds" else None
    return y, b, res, bres


@pytest.mark.parametrize("form", FORMS)
def test_plain_epilogue_is_the_separate_passes_bit_for_bit(form):
    y, b, res, bres = maps(form)
    want = separate_passes(form, y, b, res, bres)
    res_before = None if res is None else res.clone()
    launched = port_epi.launches
    if form == "bias_relu":
        got = port_epi.bias_relu_(y, b)
    else:
        got = port_epi.bias_add_relu_(y, b, res, bres)
    assert got.data_ptr() == y.data_ptr()               # in place
    assert port_epi.launches == launched                # no kernel here
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.isnan(got).any() and bool(
        ((want == 0) & torch.signbit(want)).any()) == bool(
        ((got == 0) & torch.signbit(got)).any())
    if res is not None:                                 # the residual kept
        assert torch.equal(res.view(torch.int16),
                           res_before.view(torch.int16))


@pytest.mark.parametrize("arch, want", [("resnet50", 31), ("resnet101", 82)])
def test_fast_network_makes_one_epilogue_a_convolution(monkeypatch, arch,
                                                        want):
    """With `use_pallas`, every convolution outside the fused kernel ends in
    one epilogue call: the stem's, and three a block of layer2.0, layer3 and
    layer4 (the launches the card's counter reads a forward); the mirrored
    network the same."""
    _, sd, _ = world.build_world(arch=arch, counts=(4, 6, 8))
    calls = []

    def count(fn):
        def rec(*args):
            calls.append(fn.__name__)
            return fn(*args)
        return rec

    monkeypatch.setattr(port_fast, "bias_relu_",
                        count(port_epi.bias_relu_reference))
    monkeypatch.setattr(port_fast, "bias_add_relu_",
                        count(port_epi.bias_add_relu_reference))
    x = torch.zeros((2, 32, 32, 3))
    for mirror in (False, True):
        calls.clear()
        with torch.inference_mode():
            port_fast.build_fast_apply(sd, arch, use_pallas=True,
                                       device="cpu", mirror=mirror)(x)
        assert len(calls) == want
        # each of those blocks ends in the residual form
        assert calls.count("bias_add_relu_reference") == (want - 1) // 3

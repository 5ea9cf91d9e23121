"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a GPU: a CUDA kernel has
no CPU mode (its plain version is what tests/test_torch_port_ops.py holds
against the JAX package). The file imports no JAX, so it runs on a machine
that has none:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q
"""

import importlib

import numpy as np
import pytest
import torch

port_fb = importlib.import_module("geoestimation_tpu_torch.ops.fused_bottleneck")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def block_args(n, h, w, cin, cmid, cout, proj, device, seed=0):
    rng = np.random.default_rng(seed)

    def t(shape, scale, dtype):
        a = rng.normal(0, scale, shape).astype(np.float32)
        return torch.from_numpy(a).to(device, dtype)

    bf, f32 = torch.bfloat16, torch.float32
    args = [t((n, h, w, cin), 1.0, bf), t((cmid, cin), cin ** -0.5, bf),
            t((cmid,), 0.1, f32), t((cmid, 3, 3, cmid), (9 * cmid) ** -0.5, bf),
            t((cmid,), 0.1, f32), t((cout, cmid), cmid ** -0.5, bf),
            t((cout,), 0.1, f32)]
    if proj:
        return args + [t((cout, cin), cin ** -0.5, bf), t((cout,), 0.1, f32)]
    return args + [None, None]


@pytest.mark.parametrize("shape", [
    (4, 56, 56, 64, 64, 256, True),      # layer1.0
    (4, 56, 56, 256, 64, 256, False),    # layer1.1-2
    (4, 28, 28, 512, 128, 512, False),   # layer2.1-3
    (3, 13, 11, 64, 64, 256, True),      # ragged tile edge, odd width
])
def test_kernel_matches_plain(cuda, shape):
    args = block_args(*shape, device=cuda)
    before = port_fb.fused_bottleneck.launches
    got = port_fb.fused_bottleneck(*args)
    torch.cuda.synchronize()
    assert port_fb.fused_bottleneck.launches == before + 1
    ref = port_fb.fused_bottleneck_reference(*args)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0.05,
                               atol=0.05)
    assert (got == ref).float().mean() > 0.9


def test_kernel_refuses_widths_it_does_not_take(cuda):
    args = block_args(1, 8, 8, 64, 32, 64, False, device=cuda)
    with pytest.raises(ValueError, match="CUDA kernel takes"):
        port_fb.fused_bottleneck(*args)


@pytest.mark.parametrize("shape", [
    (4, 56, 56, 256, 128, 512),    # layer2.0
    (4, 28, 28, 512, 256, 1024),   # layer3.0 (the bench's layer3entry)
    (3, 14, 10, 64, 64, 256),      # 7 output rows against 4-row tiles, W/2 odd
])
def test_s2_kernel_matches_plain(cuda, shape):
    args = block_args(*shape, proj=True, device=cuda)
    before = port_fb.fused_bottleneck_s2.launches
    got = port_fb.fused_bottleneck_s2(*args)
    torch.cuda.synchronize()
    assert port_fb.fused_bottleneck_s2.launches == before + 1
    n, h, w = shape[:3]
    assert got.shape == (n, h // 2, w // 2, shape[-1])
    ref = port_fb.fused_bottleneck_s2_reference(*args)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0.05,
                               atol=0.05)
    assert (got == ref).float().mean() > 0.9


def test_s2_kernel_refuses_widths_it_does_not_take(cuda):
    args = block_args(1, 8, 8, 64, 32, 128, True, device=cuda)
    before = port_fb.fused_bottleneck_s2.launches
    with pytest.raises(ValueError, match="CUDA kernel takes"):
        port_fb.fused_bottleneck_s2(*args)
    assert port_fb.fused_bottleneck_s2.launches == before

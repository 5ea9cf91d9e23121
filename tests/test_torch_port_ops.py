"""The port's fused bottleneck (plain PyTorch version on the CPU, the CUDA
kernel on a GPU) against the JAX package's Pallas kernel and its XLA
reference, on the same numpy-seeded inputs. Tolerances as
tests/test_fused_block.py: rtol/atol 0.05 and at least 90% of the bf16
outputs bitwise equal (the sums run in another order)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_world import one_thread_no_tensorboard  # noqa: F401

# the modules, not the functions their packages export under the same name
jax_fb = importlib.import_module("geoestimation_tpu.ops.fused_bottleneck")
port_fb = importlib.import_module("geoestimation_tpu_torch.ops.fused_bottleneck")

RNG = np.random.default_rng(0)


def make_weights(cin, cmid, cout, downsample):
    """JAX layouts: w1 (Cin, Cmid), w2 HWIO, w3 (Cmid, Cout), wd (Cin, Cout)."""
    w1 = RNG.normal(0, 0.05, (cin, cmid)).astype(np.float32)
    b1 = RNG.normal(0, 0.1, (cmid,)).astype(np.float32)
    w2 = RNG.normal(0, 0.05, (3, 3, cmid, cmid)).astype(np.float32)
    b2 = RNG.normal(0, 0.1, (cmid,)).astype(np.float32)
    w3 = RNG.normal(0, 0.05, (cmid, cout)).astype(np.float32)
    b3 = RNG.normal(0, 0.1, (cout,)).astype(np.float32)
    if downsample:
        wd = RNG.normal(0, 0.05, (cin, cout)).astype(np.float32)
        bd = RNG.normal(0, 0.1, (cout,)).astype(np.float32)
    else:
        wd = bd = None
    return w1, b1, w2, b2, w3, b3, wd, bd


def port_args(x, w1, b1, w2, b2, w3, b3, wd, bd, device="cpu"):
    """The same arrays in the port's layouts, bf16 weights, f32 biases."""
    def bf(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device, torch.bfloat16)

    def f32(a):
        return torch.from_numpy(a).to(device)

    return [bf(x), bf(w1.T), f32(b1), bf(w2.transpose(3, 0, 1, 2)),
            f32(b2), bf(w3.T), f32(b3),
            None if wd is None else bf(wd.T), None if bd is None else f32(bd)]


def assert_bf16_close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.05)
    assert np.mean(got == ref) > 0.9


@pytest.mark.parametrize(
    "shape,downsample",
    [
        ((2, 16, 16, 64), False),   # layer1-like identity block
        ((2, 16, 16, 64), True),    # with projection
        ((4, 8, 8, 128), False),    # smaller plane, Cmid 32
    ],
)
def test_plain_matches_pallas_and_xla(shape, downsample):
    cin = shape[-1]
    cmid, cout = cin // 4 if cin >= 128 else 32, cin
    ws = make_weights(cin, cmid, cout, downsample)
    x = RNG.normal(0, 1, shape).astype(np.float32)

    got = port_fb.fused_bottleneck(*port_args(x, *ws))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert_bf16_close(got, jax_fb.xla_bottleneck_reference(jnp.asarray(x),
                                                           *ws))
    assert_bf16_close(got, jax_fb.fused_bottleneck(jnp.asarray(x), *ws,
                                                   interpret=True))


@pytest.mark.parametrize("w,wbuf,downsample", [
    (28, 32, False),   # layer2 plane width
    (28, 32, True),
    (7, 16, False),    # layer4 plane width
])
def test_plain_matches_pallas_carry_mode(w, wbuf, downsample):
    """The Hopper kernel takes any W; the JAX kernel needs its carry mode
    (zero columns up to a multiple of 8) for these widths."""
    cin, cmid = 64, 32
    ws = make_weights(cin, cmid, cin, downsample)
    x = RNG.normal(0, 1, (2, 10, w, cin)).astype(np.float32)
    xpad = np.zeros((2, 10, wbuf, cin), np.float32)
    xpad[:, :, :w] = x
    ref = jax_fb.fused_bottleneck(jnp.asarray(xpad), *ws, interpret=True,
                                  logical_w=w)
    got = port_fb.fused_bottleneck(*port_args(x, *ws))
    assert_bf16_close(got.float().numpy(), np.asarray(ref, np.float32)[:, :, :w])


def test_halo_does_not_bleed_across_images():
    cin, cmid, cout = 64, 32, 64
    ws = make_weights(cin, cmid, cout, False)
    x0 = RNG.normal(0, 1, (1, 8, 8, cin)).astype(np.float32)
    zeros = np.zeros((1, 8, 8, cin), np.float32)
    pair = port_fb.fused_bottleneck(*port_args(np.concatenate([x0, zeros]),
                                               *ws))
    alone = port_fb.fused_bottleneck(*port_args(zeros, *ws))
    torch.testing.assert_close(pair[1], alone[0], rtol=0, atol=0)


def test_fold_bn_matches_jax_exactly():
    cin, cout = 8, 16
    kernel = RNG.normal(0, 0.2, (3, 3, cin, cout)).astype(np.float32)
    scale = RNG.uniform(0.5, 1.5, cout).astype(np.float32)
    bias = RNG.normal(0, 0.2, cout).astype(np.float32)
    mean = RNG.normal(0, 0.2, cout).astype(np.float32)
    var = RNG.uniform(0.5, 2.0, cout).astype(np.float32)
    jk, jb = jax_fb.fold_bn(kernel, scale, bias, mean, var, 1e-5)
    pk, pb = port_fb.fold_bn(
        torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
        *(torch.from_numpy(a) for a in (scale, bias, mean, var)), 1e-5)
    np.testing.assert_array_equal(pk.numpy(), jk.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(pb.numpy(), jb)


@pytest.mark.parametrize("bad", ["dtype", "shape", "layout", "identity",
                                 "bias_pair"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    ws = make_weights(64, 32, 64, bad == "bias_pair")
    args = port_args(RNG.normal(0, 1, (1, 4, 4, 64)).astype(np.float32), *ws)
    if bad == "dtype":
        args[0] = args[0].float()
    elif bad == "shape":
        args[3] = args[3][:, :, :2]
    elif bad == "layout":
        args[0] = args[0].permute(0, 2, 1, 3)
    elif bad == "identity":
        args[5], args[6] = args[5][:32].contiguous(), args[6][:32]
    else:
        args[8] = None
    with pytest.raises((TypeError, ValueError)):
        port_fb.fused_bottleneck(*args)


def make_weights_s2(cin, cmid, cout):
    """As tests/test_fused_block.py's TestStride2: the projection is
    required."""
    w1, b1, w2, b2, _, b3, _, _ = make_weights(cin, cmid, cout, False)
    w3 = RNG.normal(0, 0.05, (cmid, cout)).astype(np.float32)
    wd = RNG.normal(0, 0.05, (cin, cout)).astype(np.float32)
    bd = RNG.normal(0, 0.1, (cout,)).astype(np.float32)
    return w1, b1, w2, b2, w3, b3, wd, bd


@pytest.mark.parametrize("shape,npi", [
    ((2, 16, 16, 64), 1),     # layer2_block0-like
    ((4, 8, 8, 128), 2),
])
def test_s2_plain_matches_pallas_and_xla(shape, npi):
    cin = shape[-1]
    ws = make_weights_s2(cin, cin // 2, cin * 2)
    x = RNG.normal(0, 1, shape).astype(np.float32)

    got = port_fb.fused_bottleneck_s2(*port_args(x, *ws))
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == (shape[0], shape[1] // 2, shape[2] // 2,
                                cin * 2)
    got = got.float().numpy()
    assert_bf16_close(got, jax_fb.xla_bottleneck_reference(
        jnp.asarray(x), *ws, stride=2))
    assert_bf16_close(got, jax_fb.fused_bottleneck_s2(
        jnp.asarray(x), *ws, images_per_tile=npi, interpret=True))


def test_s2_plain_takes_widths_the_pallas_kernel_refuses():
    """W = 10 is not a multiple of 8 (a TPU tiling rule the Hopper kernel
    does not have): held against the XLA reference alone."""
    ws = make_weights_s2(64, 32, 128)
    x = RNG.normal(0, 1, (2, 12, 10, 64)).astype(np.float32)
    got = port_fb.fused_bottleneck_s2(*port_args(x, *ws))
    assert tuple(got.shape) == (2, 6, 5, 128)
    assert_bf16_close(got.float().numpy(), jax_fb.xla_bottleneck_reference(
        jnp.asarray(x), *ws, stride=2))


@pytest.mark.parametrize("bad", ["odd_h", "odd_w", "no_wd", "no_bd"])
def test_s2_wrapper_rejects_what_the_kernel_does_not_take(bad):
    h, w = {"odd_h": (9, 16), "odd_w": (8, 7)}.get(bad, (8, 8))
    args = port_args(RNG.normal(0, 1, (1, h, w, 64)).astype(np.float32),
                     *make_weights_s2(64, 32, 128))
    if bad == "no_wd":
        args[7] = None
    elif bad == "no_bd":
        args[8] = None
    with pytest.raises(ValueError, match="even H and W|required"):
        port_fb.fused_bottleneck_s2(*args)

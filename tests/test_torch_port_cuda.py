"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a GPU: a CUDA kernel has
no CPU mode (its plain version is what tests/test_torch_port_ops.py holds
against the JAX package). The file imports no JAX, so it runs on a machine
that has none:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q
"""

import importlib
import time

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
    # the edges of the Hopper tiling
    (2, 8, 8, 16, 64, 128, True),        # Cin 16: a K slice mostly outside Cin
    (2, 9, 12, 48, 64, 64, True),        # Cin 48: a K slice partly outside Cin
    (1, 7, 7, 256, 64, 256, False),      # one image; W 7: rows short of a tile
    (2, 6, 13, 128, 128, 128, False),    # W 13
    (2, 14, 14, 1024, 256, 1024, False),  # layer3 stride-1 blocks
    # rows too wide for a tile of whole rows: one row by column tiles
    (1, 3, 402, 64, 64, 256, True),      # the widest row at Cmid 64 in PR 2
    (1, 2, 212, 128, 128, 128, False),   # the widest row at Cmid 128 in PR 2
    (1, 3, 700, 64, 64, 64, True),       # a partial last column tile
    (2, 4, 450, 128, 64, 128, False),
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
    (3, 14, 10, 64, 64, 256),      # 7 output rows, W/2 odd
    (1, 56, 56, 256, 128, 512),    # one image at layer2.0
    (2, 10, 12, 48, 64, 128),      # Cin 48: a K slice partly outside Cin
    (2, 56, 56, 512, 256, 1024),   # layer3.0 at 448 px
    # rows too wide for a tile of whole rows: one row by column tiles
    (1, 4, 482, 64, 64, 256),      # the widest row at Cmid 64 in PR 2
    (1, 2, 126, 256, 256, 256),    # the widest row at Cmid 256 in PR 2
    (1, 4, 1200, 64, 64, 128),     # W/2 600: projection boxes per pass group
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


@pytest.mark.parametrize("name, shape", [
    ("fused_bottleneck", (80, 56, 56, 64, 64, 256, True)),
    ("fused_bottleneck", (80, 56, 56, 256, 64, 256, False)),
    ("fused_bottleneck", (80, 28, 28, 512, 128, 512, False)),
    ("fused_bottleneck_s2", (80, 56, 56, 256, 128, 512, True)),
])
def test_plan_fits_the_card(cuda, name, shape):
    """What each kernel's planner chooses at the main-path shapes fits one
    SM: shared memory within the 227 KB a block may have, a block resident."""
    plan = port_fb.kernel_plan(name, *shape)
    assert 0 < plan["smem_bytes"] <= 227 * 1024
    assert plan["blocks_per_sm"] >= 1
    assert 1 <= plan["th"] <= shape[1]
    assert 2 <= plan["stages"] <= 4


@pytest.mark.parametrize("name, shape", [
    ("fused_bottleneck", (1, 3, 700, 64, 64, 64, True)),
    ("fused_bottleneck_s2", (1, 4, 1200, 64, 64, 128, True)),
])
def test_plan_tiles_wide_rows_by_columns(cuda, name, shape):
    """Where no tile of whole rows fits, a work item is one output row and
    a tile of columns."""
    plan = port_fb.kernel_plan(name, *shape)
    out_w = shape[2] // (2 if name.endswith("s2") else 1)
    assert plan["th"] == 1 and 1 <= plan["tw"] < out_w
    assert 0 < plan["smem_bytes"] <= 227 * 1024


@pytest.mark.parametrize("name, shape", [
    ("fused_bottleneck", (1, 1, 1, 64, 10240, 64)),
    ("fused_bottleneck_s2", (1, 2, 2, 64, 7872, 64)),
])
def test_kernels_take_cmid_in_the_thousands(cuda, name, shape):
    """A Cmid so wide that one output pixel's tiles leave room only for a
    ring of one stage of the narrowest passes."""
    n, h, w, cin, cmid, cout = shape
    proj = name.endswith("s2")
    assert port_fb.kernel_plan(name, *shape, proj)["stages"] == 1
    gen = torch.Generator(device=cuda).manual_seed(0)

    def t(shape, scale, dtype):
        return (torch.randn(shape, generator=gen, device=cuda)
                * scale).to(dtype)

    bf, f32 = torch.bfloat16, torch.float32
    args = [t((n, h, w, cin), 1.0, bf), t((cmid, cin), cin ** -0.5, bf),
            t((cmid,), 0.1, f32), t((cmid, 3, 3, cmid), (9 * cmid) ** -0.5, bf),
            t((cmid,), 0.1, f32), t((cout, cmid), cmid ** -0.5, bf),
            t((cout,), 0.1, f32)]
    args += ([t((cout, cin), cin ** -0.5, bf), t((cout,), 0.1, f32)] if proj
             else [None, None])
    got = getattr(port_fb, name)(*args)
    ref = getattr(port_fb, f"{name}_reference")(*args)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0.05,
                               atol=0.05)
    assert (got == ref).float().mean() > 0.9


def test_server_answers_as_predict_batch(cuda):
    """The server on a fast engine with the stride-1 kernel answers each
    request as `predict_batch` does on the same decoded images, and every
    micro-batch launched the kernel (resnet14 at 224 px: layer1.0 is its
    one stride-1 block in layer1 and layer2)."""
    import io
    import json
    import threading
    import urllib.request

    from PIL import Image

    from geoestimation_tpu_torch.eval.engine import InferenceEngine
    from geoestimation_tpu_torch.serve import GeoInferenceServer
    from geoestimation_tpu_torch.tools import world

    config, sd, parts = world.build_world(arch="resnet14",
                                          counts=(40, 120, 360))
    engine = InferenceEngine(config, sd, partitionings=parts, n_crops=10,
                             fast=True, use_pallas=True, device=cuda)
    rng = np.random.default_rng(0)
    blobs = []
    for _ in range(8):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (300, 280, 3), np.uint8)).save(
            buf, format="JPEG", quality=90)
        blobs.append(buf.getvalue())
    srv = GeoInferenceServer(engine, port=0, batch_size=4, max_wait_ms=20)
    srv.start_background()
    try:
        images = np.stack([srv._decode(b)[0][0] for b in blobs])
        answers = [None] * len(blobs)

        def post(i):
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/predict", data=blobs[i],
                method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                answers[i] = json.loads(r.read())["predictions"]

        before = port_fb.fused_bottleneck.launches
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(blobs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        launched = port_fb.fused_bottleneck.launches - before
        batches = srv.batcher.stats()["batches"]
    finally:
        srv.close()
    assert launched == batches >= 2
    for start in range(0, len(blobs), 4):
        ref = engine.predict_batch(images[start:start + 4])
        for j in range(4):
            assert answers[start + j] == {
                k: {"class": int(c[j]), "lat": float(la[j]),
                    "lng": float(ln[j])} for k, (c, la, ln) in ref.items()}


# -- the int8 convolution (csrc/conv_s8.cu) ------------------------------------

port_conv = importlib.import_module("geoestimation_tpu_torch.ops.conv_s8")


def conv_args(n, h, cin, cout, k, stride, pad, out_hw, res_mode, device,
              seed=0):
    rng = np.random.default_rng(seed)

    def i8(shape, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(
            np.int8)).to(device)

    ho, wo = out_hw or port_conv.out_size(h, h, (k, k), stride, pad)
    x, w = i8((n, h, h, cin), -128, 128), i8((cout, k * k * cin), -127, 128)
    mult = torch.from_numpy(rng.uniform(1e-5, 2e-3, cout).astype(
        np.float32)).to(device)
    bias = torch.from_numpy(rng.normal(0, 20, cout).astype(np.float32)).to(
        device)
    res = i8((n, ho, wo, cout), -127, 128) if res_mode else None
    return (x, w, mult, bias), dict(ksize=(k, k), stride=stride, pad=pad,
                                    out_hw=out_hw, res=res, res_scale=0.37,
                                    res_mode=res_mode or "fma")


@pytest.mark.parametrize("shape, lo, rne, res_mode", [
    # the stem: a VALID 4x4 conv over the space-to-depth buffer, sliced
    ((4, 116, 16, 64, 4, 1, 0, (112, 112)), 0.0, False, None),
    ((4, 56, 64, 64, 3, 1, 1, None), 0.0, False, None),        # 3x3 requant
    ((4, 56, 64, 256, 1, 1, 0, None), -127.0, False, None),    # signed _y3
    ((4, 56, 256, 64, 1, 1, 0, None), 0.0, True, None),        # rne
    ((4, 56, 64, 256, 1, 1, 0, None), 0.0, False, "fma"),      # identity tail
    ((4, 56, 256, 512, 1, 2, 0, None), 0.0, False, "mul_add"),  # entry tail
    ((4, 56, 128, 128, 3, 2, 1, None), 0.0, True, None),       # 3x3 stride 2
    ((2, 7, 512, 512, 3, 1, 1, None), 0.0, False, None),       # layer4
    ((3, 9, 32, 24, 3, 2, 1, None), 0.0, False, "fma"),        # ragged edges
    ((1, 5, 16, 8, 1, 1, 0, None), -127.0, True, "mul_add"),   # tiny
])
def test_conv_s8_matches_plain_bitwise(cuda, shape, lo, rne, res_mode):
    """Integer products and the written-out float32 epilogue leave no room:
    the kernel equals its plain version bit for bit."""
    args, kw = conv_args(*shape, res_mode, device=cuda)
    before = port_conv.conv_s8.launches
    got = port_conv.conv_s8(*args, lo=lo, rne=rne, **kw)
    torch.cuda.synchronize()
    assert port_conv.conv_s8.launches == before + 1
    ref = port_conv.conv_s8_reference(*args, lo=lo, rne=rne, **kw)
    assert got.dtype == torch.int8 and got.shape == ref.shape
    assert torch.equal(got, ref)


@pytest.mark.parametrize("shape, lo, rne, res_mode, mode, maps", [
    # many waves of a persistent grid: 1,960 tiles over 264 blocks, the
    # weights resident, the identity residual by TMA
    ((40, 56, 64, 256, 1, 1, 0, None), 0.0, False, "fma", "flat", 1),
    # a partial last sub-box in M (507 pixels) and chunk in Cout (72 of 128)
    ((3, 13, 48, 72, 1, 1, 0, None), 0.0, True, None, "flat", 1),
    # 9 chunks of 64 channels, the last partial; weights streamed
    ((2, 9, 64, 520, 3, 1, 1, None), 0.0, False, None, "box", 1),
    # stride 2 phases, partial sub-boxes, the entry residual by TMA
    ((2, 23, 64, 128, 3, 2, 1, None), 0.0, False, "mul_add", "box", 4),
    # 128-byte sub-slices, stride 2, Cout 72 stored by 8-byte stores
    ((2, 13, 128, 72, 3, 2, 1, None), 0.0, True, "fma", "box", 4),
    # 5x5 stride 3: 9 phase maps in global memory; Cout 40 takes the
    # residual by 8-byte loads
    ((2, 11, 32, 40, 5, 3, 2, None), 0.0, False, "fma", "box", 9),
    # 7x7 stride 16: 49 phase maps
    ((2, 16, 16, 32, 7, 16, 3, None), -127.0, False, "mul_add", "box", 49),
    # a plane narrower than the stride: phases with no input pixel
    ((2, 2, 16, 16, 3, 4, 1, None), 0.0, False, None, "box", 9),
    # folded taps: 2 of 32 channels, and the stem's 4 of 16 sliced
    ((2, 30, 32, 64, 2, 1, 0, None), 0.0, False, None, "fold", 2),
    ((2, 20, 16, 24, 4, 1, 0, (15, 13)), 0.0, True, None, "fold", 4),
])
def test_conv_s8_plans_match_plain_bitwise(cuda, shape, lo, rne, res_mode,
                                           mode, maps):
    """Each of the planner's modes and edges, bit for bit."""
    args, kw = conv_args(*shape, res_mode, device=cuda)
    n, h, cin, cout, k, stride, pad, out_hw = shape
    ho, wo = out_hw or port_conv.out_size(h, h, (k, k), stride, pad)
    plan = port_conv.kernel_plan(n, h, h, cin, ho, wo, cout, k, k, stride,
                                 pad, res_mode is not None)
    assert (plan["mode"], plan["maps"]) == (mode, maps)
    got = port_conv.conv_s8(*args, lo=lo, rne=rne, **kw)
    torch.cuda.synchronize()
    ref = port_conv.conv_s8_reference(*args, lo=lo, rne=rne, **kw)
    assert torch.equal(got, ref)


def test_conv_s8_refuses_widths_it_does_not_take(cuda):
    args, kw = conv_args(1, 6, 8, 16, 1, 1, 0, None, None, device=cuda)
    before = port_conv.conv_s8.launches
    with pytest.raises(ValueError, match="CUDA kernel takes"):
        port_conv.conv_s8(*args, **kw)
    assert port_conv.conv_s8.launches == before


def test_conv_s8_output_past_2_gib(cuda):
    """The stem at 2,720 crops (272 images x 10): its int8 output, 2.18 GB,
    passes 2^31 bytes. The first and last images equal the plain version's
    on those images alone."""
    n, h, cin, cout = 2720, 116, 16, 64
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randint(-128, 128, (n, h, h, cin), generator=gen, device=cuda,
                      dtype=torch.int8)
    (_, w, mult, bias), kw = conv_args(1, h, cin, cout, 4, 1, 0, (112, 112),
                                       None, device=cuda)
    got = port_conv.conv_s8(x, w, mult, bias, **kw)
    torch.cuda.synchronize()
    assert got.numel() > 2 ** 31
    for part in (slice(0, 2), slice(n - 2, n)):
        ref = port_conv.conv_s8_reference(x[part].contiguous(), w, mult,
                                          bias, **kw)
        assert torch.equal(got[part], ref)


def test_int8_network_on_the_kernel_matches_plain(cuda):
    """The int8 resnet14 on the card: one conv_s8 launch per convolution
    (stem + 4 blocks x 3 + 4 downsamples), and logits equal to the same
    network run through the plain version on the card."""
    from geoestimation_tpu_torch.ingest.pipeline import eval_pipeline_s8
    from geoestimation_tpu_torch.models import quant
    from geoestimation_tpu_torch.tools import world

    _, sd, _ = world.build_world(arch="resnet14", counts=(40, 120, 360))
    qnet = quant.quantize_model(sd, "resnet14")
    images = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 256, 256, 3), dtype=np.uint8)).to(cuda)
    scales = quant.calibrate(sd, [images.cpu().numpy()], "resnet14",
                             device=cuda)
    x = eval_pipeline_s8(images)
    before = port_conv.conv_s8.launches
    got = quant.build_int8_apply(qnet, scales, device=cuda)(x)
    torch.cuda.synchronize()
    assert port_conv.conv_s8.launches == before + 17
    ref = quant.build_int8_apply(qnet, scales, device=cuda, plain=True)(x)
    assert port_conv.conv_s8.launches == before + 17
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


# -- the TTA variants' new shapes (feature TTA's trunk on 256-px bases) -----------

@pytest.mark.parametrize("name, shape", [
    ("fused_bottleneck", (4, 64, 64, 64, 64, 256, True)),      # layer1.0
    ("fused_bottleneck", (4, 64, 64, 256, 64, 256, False)),    # layer1.1-2
    ("fused_bottleneck", (4, 32, 32, 512, 128, 512, False)),   # layer2.1-3
    ("fused_bottleneck_s2", (4, 64, 64, 256, 128, 512, True)),  # layer2.0
])
def test_kernels_match_plain_at_feature_tta_shapes(cuda, name, shape):
    """The bf16 kernels on feature TTA's 64- and 32-wide planes (the
    stride-2 one only under use_pallas_s2)."""
    args = block_args(*shape, device=cuda)
    kernel = getattr(port_fb, name)
    before = kernel.launches
    got = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = getattr(port_fb, f"{name}_reference")(*args)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0.05,
                               atol=0.05)
    assert (got == ref).float().mean() > 0.9


def _ftta_conv_shapes():
    from geoestimation_tpu_torch.tools.bench_kernels import int8_conv_shapes

    return [(label, key) for label, key, _ in int8_conv_shapes(2, crop=256)
            if not label.startswith("layer4")]


@pytest.mark.parametrize("label, key", _ftta_conv_shapes(),
                         ids=[label for label, _ in _ftta_conv_shapes()])
def test_conv_s8_matches_plain_at_feature_tta_shapes(cuda, label, key):
    """conv_s8 bit for bit at every convolution of the int8 feature-TTA
    trunk on 256-px bases: the stem over a 132-wide space-to-depth buffer
    (128 x 128 outputs), layer1 at 64, layer2 at 64 and 32, layer3 at 32
    and 16."""
    n, h, cin, cout, k, stride, pad, out_hw, lo, res_mode = key
    args, kw = conv_args(n, h, cin, cout, k, stride, pad, out_hw, res_mode,
                         device=cuda)
    got = port_conv.conv_s8(*args, lo=lo, **kw)
    torch.cuda.synchronize()
    ref = port_conv.conv_s8_reference(*args, lo=lo, **kw)
    assert torch.equal(got, ref)


# -- QAT on the card (cuDNN through autograd; the int8 network on conv_s8) ----

def _qat_world(cuda):
    from geoestimation_tpu_torch.ingest.pipeline import eval_pipeline_s8
    from geoestimation_tpu_torch.models import quant
    from geoestimation_tpu_torch.tools import world

    counts = (40, 120, 360)
    _, sd, _ = world.build_world(arch="resnet14", counts=counts)
    images = np.random.default_rng(2).integers(0, 256, (4, 72, 72, 3),
                                               dtype=np.uint8)
    scales = quant.calibrate(sd, [images], "resnet14", n_crops=1, crop=64,
                             device=cuda)
    x = eval_pipeline_s8(torch.from_numpy(images).to(cuda), n_crops=1,
                         crop=64)
    return sd, counts, images, scales, x


def test_qat_forward_tracks_the_int8_network_on_the_kernel(cuda):
    """The fake-quant forward of a resnet14 at 64 px against the int8
    network on conv_s8 (17 launches), on the same crops and scales: within
    0.02 of each head's logit spread, the same argmax (the contract of
    tests/test_qat.py:200)."""
    from geoestimation_tpu_torch.eval.engine import resolve_device
    from geoestimation_tpu_torch.models import qat, quant

    resolve_device(cuda)   # TF32 off: the grid decides on float32 values
    sd, counts, _, scales, x = _qat_world(cuda)
    with torch.no_grad():
        got = qat.build_qat_apply("resnet14", scales, n_classes=counts)(
            qat.fold_variables(sd, "resnet14", device=cuda), x.float())
    before = port_conv.conv_s8.launches
    ref = quant.build_int8_apply(quant.quantize_model(sd, "resnet14"),
                                 scales, n_classes=counts, device=cuda)(x)
    torch.cuda.synchronize()
    assert port_conv.conv_s8.launches == before + 17
    for g, r in zip(got, ref):
        spread = float(r.max() - r.min())
        assert float((g - r).abs().max()) < 0.02 * spread
        assert torch.equal(g.argmax(-1), r.argmax(-1))


def test_qat_step_on_the_card_launches_no_kernel(cuda):
    """One anchored QAT step of a resnet14 at 64 px on the card: a finite
    loss, every leaf updated, and none of the hand-written kernels
    launched."""
    from geoestimation_tpu_torch.eval.engine import resolve_device
    from geoestimation_tpu_torch.models import qat
    from geoestimation_tpu_torch.train.optim import (
        Optimizer,
        constant_schedule,
    )

    resolve_device(cuda)
    sd, counts, images, scales, _ = _qat_world(cuda)
    folded = qat.fold_variables(sd, "resnet14", device=cuda,
                                requires_grad=True)
    leaves = [t for _, t in qat.folded_leaves(folded)]
    before = [t.detach().clone() for t in leaves]
    step = qat.make_qat_train_step(
        qat.build_qat_apply("resnet14", scales, n_classes=counts),
        Optimizer(leaves, constant_schedule(1e-3), "sgd", momentum=0.9),
        crop=56, crop_scale=(0.66, 1.0), anchor_weight=0.5,
        teacher_apply=qat.build_qat_apply("resnet14", scales, counts,
                                          fake_quant=False),
        teacher_folded=qat.fold_variables(sd, "resnet14", device=cuda))
    labels = torch.from_numpy(np.stack(
        [np.arange(4) % n for n in counts]).astype(np.int32)).to(cuda)
    counters = (port_fb.fused_bottleneck, port_fb.fused_bottleneck_s2,
                port_conv.conv_s8)
    launched = [c.launches for c in counters]
    m = step(folded, torch.from_numpy(images).to(cuda), labels, 0, 0)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == launched
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["anchor_kl"]))
    assert sum(not torch.equal(a, b) for a, b in zip(leaves, before)) \
        > len(leaves) // 2


port_bn = importlib.import_module("geoestimation_tpu_torch.ops.bn_train")
port_resnet = importlib.import_module("geoestimation_tpu_torch.models.resnet")
# each distinct (shape, form) of ResNet50's train-mode BatchNorms at batch
# 256 and 224 px
BN_SHAPES = sorted({(shape, form) for _, shape, form in
                    port_resnet.train_norms("resnet50", 256, 224)})


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape, form", BN_SHAPES)
def test_bn_train_kernels_match_plain_at_resnet50_train_shapes(cuda, shape,
                                                               form, dtype):
    """Each of the four kernels against its plain version on the same
    inputs, with chip_smoke.py phase 14's gates; the reductions the same
    bits on a second run."""
    smoke = importlib.import_module("chip_smoke")
    smoke.check_bn_train(shape, form, getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", ["relu", "identity", "projection"])
def test_bn_train_function_on_the_card_matches_the_cpu(cuda, dtype, case):
    """The autograd Function at a ragged shape (N 3, 9 x 7, C 64): out,
    statistics and every gradient of the card's kernels (4 launches a
    BatchNorm) within rounding of the plain version's on the CPU."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(7)

    def maps(c=64):
        a = rng.normal(0.3, 1.5, (3, 9, 7, c)).astype(np.float32)
        return torch.from_numpy(a).to(dt).permute(0, 3, 1, 2)

    x, res, xd, cot = maps(), maps(), maps(), maps()
    params = [torch.from_numpy(rng.normal(m, 0.3, 64).astype(np.float32))
              for m in (1, 0, 1, 0)]

    def run(device):
        leaves = [t.to(device).requires_grad_() for t in
                  (x, res, xd, *params)]
        xl, rl, xdl, w, b, wd, bd = leaves
        if case == "projection":
            rl = port_bn.bn_train(xdl, wd, bd, 1e-5)[0]
        out, mean, var = port_bn.bn_train(
            xl, w, b, 1e-5, relu=True,
            residual=None if case == "relu" else rl)
        grads = torch.autograd.grad((out.float() * cot.to(device).float())
                                    .sum(), leaves, allow_unused=True)
        return [t.detach().cpu().float() for t in (out, mean, var)] + [
            torch.zeros(1) if g is None else g.cpu().float() for g in grads]

    launched = port_bn.bn_train.launches
    got = run(cuda)
    torch.cuda.synchronize()
    n_norms = 2 if case == "projection" else 1
    assert port_bn.bn_train.launches - launched == 4 * n_norms
    want = run("cpu")
    tol = 2 ** -7 if dt == torch.bfloat16 else 1e-5
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1e-6)
        assert float((g - w).abs().max()) <= tol * scale


def test_bn_train_refuses_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(2, 24, 4, 4, dtype=torch.bfloat16, device=cuda)
    w = torch.ones(24, device=cuda)
    with pytest.raises(ValueError, match="take C"):
        port_bn.bn_train(x.contiguous(memory_format=torch.channels_last), w,
                         w, 1e-5)
    with pytest.raises(ValueError, match="channels-last"):
        port_bn.bn_train(torch.zeros(2, 64, 4, 4, dtype=torch.bfloat16,
                                     device=cuda), w.repeat(3)[:64],
                         w.repeat(3)[:64], 1e-5)


def test_host_feed_keeps_a_staging_buffer_until_its_copy_is_done(cuda):
    """Feeds of one shape queued behind a sleeping kernel: the first two go
    up from the two pinned staging buffers without waiting for the card,
    the third reuses the first one's buffer only once that copy is done,
    and every array arrives as it was."""
    from geoestimation_tpu_torch.train.loop import HostFeed

    feed = HostFeed(cuda)
    arrays = [np.full((64, 256, 256, 3), k, np.uint8) for k in range(1, 6)]
    feed(arrays[0])
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    end.synchronize()
    cycles_per_ms = 10 ** 7 / start.elapsed_time(end)
    torch.cuda._sleep(int(500 * cycles_per_ms))
    t0 = time.perf_counter()
    outs = [feed(a) for a in arrays[:2]]
    queued_s = time.perf_counter() - t0
    outs += [feed(a) for a in arrays[2:]]
    waited_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    assert queued_s < 0.25 < waited_s
    for arr, out in zip(arrays, outs):
        assert torch.equal(out.cpu(), torch.from_numpy(arr))

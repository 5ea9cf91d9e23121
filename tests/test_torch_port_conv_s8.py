"""The int8 convolution kernel's planner (`ops.conv_s8.kernel_plan`), on the
CPU: every convolution of the int8 ResNet50 gets a plan that fits the
card's shared memory, whose tiles cover every output pixel and channel once
and whose K sub-slices cover K once; and every shape the kernel took before
its planner existed is still taken. What the kernel computes with a plan is
held to the plain version on the card (tests/test_torch_port_cuda.py).
The tools' bound counts the input bytes the taps read, no more."""

import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ops = importlib.import_module("geoestimation_tpu_torch.ops.conv_s8")
bench = importlib.import_module("geoestimation_tpu_torch.tools.bench_kernels")

SHAPES = [(label, key) for n in (80, 640)
          for label, key, _ in bench.int8_conv_shapes(n)] + [
    (label, key) for label, key, _ in bench.INT8_EDGES]


def _dims(key):
    n, h, cin, cout, k, s, p, out_hw, _, res_mode = key
    ho, wo = out_hw or ops.out_size(h, h, (k, k), s, p)
    return n, h, h, cin, ho, wo, cout, k, k, s, p, res_mode is not None


def _cdiv(a, b):
    return -(-a // b)


def _rows(plan, dims):
    """Output pixel (n, oy, ox) of every row of every tile, or None where
    the row lies outside the output: the kernel's `sub_box` and
    `row_offset`, written out."""
    n, h, w, _, ho, wo, _, _, kw, _, _, _ = dims
    bw, bh = plan["bw"], plan["bh"]
    tile = plan["wg"] * plan["mt"]      # sub-boxes of a tile
    if plan["mode"] == "flat":
        for sb in range(_cdiv(plan["subs"], tile) * tile):
            for pix in range(64):
                m = sb * 64 + pix
                yield (None if m >= n * ho * wo else
                       (m // (ho * wo), m // wo % ho, m % wo))
        return
    nres = plan["maps"] if plan["mode"] == "fold" else 1
    fold = kw if plan["mode"] == "fold" else 1
    nbx = _cdiv(_cdiv(wo, fold), bw)
    nby = _cdiv(ho, bh)
    assert plan["subs"] == n * nres * nbx * nby
    for sb in range(_cdiv(plan["subs"], tile) * tile):
        img, rem = divmod(sb, nres * nby * nbx)
        r, rem = divmod(rem, nby * nbx)
        by, bx = divmod(rem, nbx)
        for pix in range(64):
            oy = by * bh + pix // bw
            ox = (bx * bw + pix % bw) * fold + r
            yield (img, oy, ox) if img < n and oy < ho and ox < wo else None


@pytest.mark.parametrize("label, key", SHAPES,
                         ids=[f"{k[0]}-{lab}" for lab, k in SHAPES])
def test_every_convolution_gets_a_plan_that_fits(label, key):
    dims = _dims(key)
    plan = ops.kernel_plan(*dims)
    n, h, w, cin, ho, wo, cout, kh, kw, s, p, has_res = dims
    assert plan["mode"] in ops.MODES
    assert (plan["mt"], plan["bn"]) in ops.TILE_SHAPES
    assert plan["bw"] * plan["bh"] == 64
    # shared memory: as many blocks as share an SM, and the 1 KB each
    # reserves, within its 228 KB
    wg = plan["wg"]
    assert plan["smem"] <= ops.SMEM_PER_BLOCK[wg] <= 227 * 1024
    assert ops.BLOCKS_PER_SM[wg] * (plan["smem"] + 1024) <= 228 * 1024
    assert 2 <= plan["stages"] <= ops.MAX_STAGES
    assert plan["g"] in ops.SLICES_PER_STAGE and plan["nq"] % plan["g"] == 0
    assert plan["sb"] == (128 if cin % 128 == 0 and plan["mode"] != "fold"
                          else 64)
    if plan["b_resident"]:
        assert plan["nq"] * plan["nch"] * plan["bn"] * plan["sb"] \
            <= ops.B_RESIDENT_MAX
    # the tiles cover Cout, and M (by sub-boxes of 64 pixels)
    assert plan["nch"] == _cdiv(cout, plan["bn"])
    assert plan["tiles"] == _cdiv(plan["subs"], wg * plan["mt"]) * plan["nch"]
    assert 64 * plan["subs"] >= n * ho * wo
    assert 1 <= plan["grid"] <= min(plan["tiles"],
                                    ops.BLOCKS_PER_SM[wg] * ops._sms())
    # weights resident: one warpgroup, two blocks an SM; streamed: two
    assert wg == (1 if plan["b_resident"] else 2)
    # the forward's shapes: the stem folds its taps, 1x1 stride-1 convs are
    # plain matrices, everything else goes by 4-D boxes
    if "stem" in label:
        assert plan["mode"] == "fold" and plan["maps"] == 4
    elif kh == 1 and s == 1:
        assert plan["mode"] == "flat"
    elif key[0] in (80, 640):
        assert plan["mode"] == "box"


@pytest.mark.parametrize("key", [
    (2, 9, 32, 24, 3, 2, 1, None, 0.0, "fma"),          # ragged edge
    (1, 5, 16, 8, 1, 1, 0, None, -127.0, "mul_add"),    # tiny
    (2, 22, 16, 64, 4, 1, 0, (18, 17), 0.0, None),      # stem-like, sliced
    (2, 30, 32, 40, 2, 1, 0, None, 0.0, None),          # 2 folded taps
    (3, 14, 64, 128, 3, 2, 1, None, 0.0, None),         # 7x7 out, stride 2
    (2, 13, 48, 72, 1, 1, 0, None, 0.0, "fma"),         # partial M and Cout
    (1, 11, 16, 16, 5, 3, 2, None, 0.0, None),          # 9 phases
    (2, 2, 16, 16, 3, 4, 1, None, 0.0, None),           # plane under stride
], ids=["ragged", "tiny", "stem_sliced", "fold2", "s2_7x7", "partial",
        "phases", "under_stride"])
def test_tiles_cover_each_output_pixel_once(key):
    dims = _dims(key)
    n, _, _, _, ho, wo = dims[:6]
    plan = ops.kernel_plan(*dims)
    rows = [r for r in _rows(plan, dims) if r is not None]
    assert len(rows) == len(set(rows)) == n * ho * wo


def _slices(plan, dims):
    """(tap, first channel) of every K sub-slice (sb bytes), and its weight
    column: the kernel's `TapWalk`, written out."""
    _, _, _, cin, _, _, _, kh, kw, _, _, _ = dims
    sb = plan["sb"]
    if plan["mode"] == "flat":
        return [(0, sb * q, sb * q) for q in range(plan["nq"])]
    if plan["mode"] == "fold":      # one row of kw taps, 64 bytes, per ky
        return [(ky * kw, 0, 64 * ky) for ky in range(plan["nq"])]
    cs = _cdiv(cin, sb)
    return [(q // cs, sb * (q % cs), q // cs * cin + sb * (q % cs))
            for q in range(plan["nq"])]


@pytest.mark.parametrize("cin, k, stride, pad", [
    (16, 4, 1, 0), (32, 2, 1, 0), (48, 3, 2, 1), (64, 3, 1, 1),
    (80, 3, 1, 1), (256, 1, 1, 0), (112, 1, 2, 0), (512, 3, 2, 1),
])
def test_sub_slices_partition_k(cin, k, stride, pad):
    """Each weight column of K = KH*KW*Cin is read by exactly one sub-slice
    against real activations: a sub-slice's channels past a tap's Cin read
    zeros (TMA's fill), whatever weights lie there."""
    h = 12
    ho, wo = ops.out_size(h, h, (k, k), stride, pad)
    dims = (2, h, h, cin, ho, wo, 64, k, k, stride, pad, False)
    plan = ops.kernel_plan(*dims)
    hits = np.zeros(k * k * cin, int)
    for tap, c0, wcol in _slices(plan, dims):
        if plan["mode"] == "fold":          # all kw taps of a row, in order
            hits[wcol:wcol + 64] += 1
            continue
        real = min(plan["sb"], cin - c0)    # channels of this tap it holds
        assert wcol == tap * cin + c0
        hits[wcol:wcol + real] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("seed", range(4))
def test_every_shape_taken_before_is_taken(seed):
    """Random convolutions the kernel took before it had a planner (Cin a
    multiple of 16, Cout of 8, any kernel size, stride and padding, with
    or without a residual, N*Ho*Wo in int32): each gets a plan that fits."""
    rng = np.random.default_rng(seed)
    for _ in range(150):
        k = int(rng.integers(1, 8))
        stride = int(rng.integers(1, 17))
        pad = int(rng.integers(0, 4))
        h = int(rng.integers(max(1, k - 2 * pad), 40))
        cin = 16 * int(rng.integers(1, 40))
        cout = 8 * int(rng.integers(1, 300))
        if k * k * cin * cout >= ops.MAX_WEIGHTS:
            continue
        ho, wo = ops.out_size(h, h, (k, k), stride, pad)
        if ho < 1:
            continue
        n = int(rng.integers(1, 700))
        plan = ops.kernel_plan(n, h, h, cin, ho, wo, cout, k, k, stride, pad,
                               bool(rng.integers(0, 2)))
        assert plan["smem"] <= ops.SMEM_PER_BLOCK[plan["wg"]]
        assert plan["maps"] == min(k, stride) ** 2 or plan["mode"] != "box"


def test_refuses_what_it_never_took():
    with pytest.raises(ValueError, match="Cin % 16 == 0"):
        ops.kernel_plan(1, 8, 8, 24, 8, 8, 16, 1, 1, 1, 0, False)
    with pytest.raises(ValueError, match="Cout % 8 == 0"):
        ops.kernel_plan(1, 8, 8, 16, 8, 8, 12, 1, 1, 1, 0, False)
    with pytest.raises(ValueError, match="N\\*Ho\\*Wo"):
        ops.kernel_plan(ops.MAX_PIXELS // 64 + 1, 8, 8, 16, 8, 8, 16, 1, 1,
                        1, 0, False)


N80 = [(label, key) for label, key, _ in bench.int8_conv_shapes(80)] + [
    (label, key) for label, key, _ in bench.INT8_EDGES]


@pytest.mark.parametrize("label, key", N80, ids=[lab for lab, _ in N80])
def test_bound_counts_the_input_pixels_the_taps_read(label, key):
    """`conv_s8_cost`'s bytes: the input pixels whose gradient through the
    convolution (ones as weights, the output sliced to `out_hw`) is not
    zero, times Cin, plus weights, mult and bias, residual and output."""
    n, h, cin, cout, k, s, p, out_hw, _, res_mode = key
    ho, wo = out_hw or ops.out_size(h, h, (k, k), s, p)
    x = torch.zeros((1, 1, h, h), dtype=torch.float64, requires_grad=True)
    y = F.conv2d(x, torch.ones((1, 1, k, k), dtype=torch.float64), stride=s,
                 padding=p)
    y[..., :ho, :wo].sum().backward()
    read = int((x.grad != 0).sum())
    cin = bench.STEM_S2D_CIN if k == 4 else cin
    out = n * ho * wo * cout
    nops, nbytes = bench.conv_s8_cost(key)
    assert nops == 2 * out * k * k * cin
    assert nbytes == (n * read * cin + cout * k * k * cin + 8 * cout
                      + out * (2 if res_mode else 1))
    if k == 1 and s > 1:        # one pixel in s * s
        assert read == _cdiv(h, s) ** 2

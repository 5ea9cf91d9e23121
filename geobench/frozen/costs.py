"""The cost functions of the port's kernels and the card's published peaks,
frozen: `block_cost`, `int8_conv_shapes` and `conv_s8_cost` of
`geoestimation_tpu_torch/tools/bench_kernels.py` (with `out_size` of
`ops/conv_s8.py`), and the peaks of `tools/card.py`."""

from __future__ import annotations

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
H100_BF16_FLOPS = 989e12      # bf16 tensor-core peak
H100_INT8_OPS = 1979e12       # int8 tensor-core peak
H100_BYTES_PER_S = 3.35e12    # HBM3 rate
PEAKS = {"bf16": H100_BF16_FLOPS, "int8": H100_INT8_OPS}

STAGE_SIZES = {"resnet14": (1, 1, 1, 1), "resnet50": (3, 4, 6, 3),
               "resnet101": (3, 4, 23, 3)}
STEM_S2D_CIN = 12       # the int8 stem's space-to-depth channels, unpadded


def bound_s(ops, nbytes, peak):
    """The least time in seconds: the larger of the operations over `peak`
    and the bytes over the memory rate."""
    return max(ops / peak, nbytes / H100_BYTES_PER_S)


def block_cost(n, h, w, cin, cmid, cout, proj, stride=1):
    """(FLOPs, bytes) of one bottleneck block: FLOPs as the JAX kernels'
    cost estimates count them; bytes = x read once + out written once +
    weights + biases."""
    h2, w2 = h // stride, w // stride
    flops = 2 * n * (h * w * cin * cmid + h2 * w2 * (
        9 * cmid * cmid + cmid * cout + (cin * cout if proj else 0)))
    weights = cin * cmid + 9 * cmid * cmid + cmid * cout \
        + (cin * cout if proj else 0)
    biases = 2 * cmid + cout + (cout if proj else 0)
    nbytes = 2 * n * (h * w * cin + h2 * w2 * cout) + 2 * weights \
        + 4 * biases
    return flops, nbytes


def fused_stride1_blocks(n, arch="resnet50", crop=224, stages=(0, 1)):
    """[(n, h, w, cin, cmid, cout, proj)] of the stride-1 blocks that the
    stride-1 fused kernel computes in the bf16 fast path (layer1 and
    layer2's stride-1 blocks: `models/fast_infer.py` `PALLAS_STAGES`), at n
    crops of `crop` px."""
    out, h, cin = [], crop // 4, 64
    for stage, n_blocks in enumerate(STAGE_SIZES[arch]):
        mid = 64 * 2 ** stage
        for b in range(n_blocks):
            s = 2 if stage > 0 and b == 0 else 1
            if s == 1 and stage in stages:
                out.append((n, h, h, cin, mid, 4 * mid, cin != 4 * mid))
            h, cin = (h - 1) // s + 1, 4 * mid
    return out


def out_size(h, w, ksize, stride, pad):
    kh, kw = ksize
    return (h + 2 * pad - kh) // stride + 1, (w + 2 * pad - kw) // stride + 1


def int8_conv_shapes(n=80, arch="resnet50", crop=224):
    """[(label, (N, H, Cin, Cout, K, stride, pad, out_hw, lo, res_mode),
    launches per forward)] of every distinct convolution of the int8
    ResNet at `crop`-px crops, N crops: the stem over its space-to-depth
    buffer, and each block's 1x1, 3x3 and conv3 (the stage entries' conv3
    requantized alone, their downsample conv with the entry residual; the
    identity blocks' conv3 with the identity residual)."""
    shapes = {}

    def add(label, key):
        shapes.setdefault(key, [label, 0])[1] += 1

    add("stem 4x4 space-to-depth", (n, (crop + 8) // 2, 16, 64, 4, 1, 0,
                                     (crop // 2, crop // 2), 0.0, None))
    h, cin = crop // 4, 64
    for stage, n_blocks in enumerate(STAGE_SIZES[arch]):
        mid, layer = 64 * 2 ** stage, f"layer{stage + 1}"
        for b in range(n_blocks):
            s = 2 if stage > 0 and b == 0 else 1
            ho = (h - 1) // s + 1
            add(f"{layer} conv1 1x1 {cin}-{mid} @{h}",
                (n, h, cin, mid, 1, 1, 0, None, 0.0, None))
            add(f"{layer} conv2 3x3/{s} {mid} @{h}",
                (n, h, mid, mid, 3, s, 1, None, 0.0, None))
            if b == 0:
                add(f"{layer} conv3 1x1 {mid}-{4 * mid} signed @{ho}",
                    (n, ho, mid, 4 * mid, 1, 1, 0, None, -127.0, None))
                add(f"{layer} downsample 1x1/{s} {cin}-{4 * mid} + entry "
                    f"residual @{h}", (n, h, cin, 4 * mid, 1, s, 0, None, 0.0,
                                      "mul_add"))
            else:
                add(f"{layer} conv3 1x1 {mid}-{4 * mid} + identity residual "
                    f"@{ho}", (n, ho, mid, 4 * mid, 1, 1, 0, None, 0.0,
                               "fma"))
            h, cin = ho, 4 * mid
    return [(label, key, count) for key, (label, count) in shapes.items()]


def _taps_reach(size, out, k, stride, pad):
    """How many of an input's `size` rows (or columns) the taps of `out`
    output rows read: all of them where k >= stride, one in `stride` for
    a strided 1x1 convolution."""
    return len({o * stride + t - pad for o in range(out) for t in range(k)}
               & set(range(size)))


def conv_s8_cost(key):
    """(operations, bytes) of one convolution: 2 per multiply-add; each
    input byte that a tap reads, each residual and weight byte read once,
    each output byte written once, mult and bias 8 bytes a channel. The
    stem counts the function's 12 space-to-depth channels, not the 16 it is
    launched with."""
    n, h, cin, cout, k, s, p, out_hw, _, res_mode = key
    ho, wo = out_hw or out_size(h, h, (k, k), s, p)
    cin = STEM_S2D_CIN if k == 4 else cin
    out = n * ho * wo * cout
    x_bytes = (n * _taps_reach(h, ho, k, s, p) * _taps_reach(h, wo, k, s, p)
               * cin)
    return (2 * out * k * k * cin,
            x_bytes + cout * k * k * cin + 8 * cout
            + out * (2 if res_mode else 1))


def conv_s8_forward_bound_s(n, arch="resnet50", crop=224):
    """(seconds, launches): the least time of one int8 forward's
    convolutions at n crops, summed over its launches, and their count."""
    total, launches = 0.0, 0
    for _, key, count in int8_conv_shapes(n, arch, crop):
        total += count * bound_s(*conv_s8_cost(key), H100_INT8_OPS)
        launches += count
    return total, launches


def fused_bottleneck_forward_bound_s(n, arch="resnet50", crop=224):
    """(seconds, launches): the least time of the stride-1 fused blocks of
    one bf16 forward at n crops, and their count."""
    blocks = fused_stride1_blocks(n, arch, crop)
    return (sum(bound_s(*block_cost(*b), H100_BF16_FLOPS) for b in blocks),
            len(blocks))

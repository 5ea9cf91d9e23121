"""The int8 stem's bit-identical forms, timed against each other on the card.

    python -m geoestimation_tpu_torch.tools.bench_stem [--crops 1120] \\
        [--iters 30] [--pool_modes reduce_window]

The port of the JAX package's `tools/bench_stem.py`, with its flags. The
int8 stem (7x7 stride-2 convolution, requant, 3x3 stride-2 max pool) takes
(B, 224, 224, 3) int8 crops to (B, 56, 56, 64) int8. Its forms differ in how
the taps are laid into channels:

  s2d      (shipped, `models/quant.py`) 2x2 pixel blocks -> a 4x4
           convolution, Cin 12 padded to 16 (`conv_s8` in `fold` mode)
  direct   (control) the 7x7 stride-2 convolution over a buffer filled
           with the border value, Cin 3 padded to 16 with zero weights
           (the kernel takes Cin % 16 == 0; the same integer sums)
  hfold48  s2d with its 4 W block-taps folded into Cin 48 -> a (4, 1)
           convolution (`box` mode)
  hfold24  s2d with pairs of W block-taps folded into Cin 24 -> a (4, 2)
           convolution with a W dilation of 2, which `conv_s8` does not
           take: this form has no kernel route

Each form with a kernel route runs its convolution and requant (round half
to even, clipped to [0, 127]) in one `conv_s8` launch; a shape the kernel's
planner refuses raises. Every form is also run through the library: the
same buffer, im2col and one `torch._int_mm`, then a requant either exact
(the kernel's plain one, `ops.conv_s8.requant_reference`, which imitates
the kernel's float32 FMA in float64: the route the check uses) or as a
user would write it (float32 multiply, add, round, clip: not bit-exact,
the route that is timed). The pool is the port's one
(`models/quant.py` `max_pool_3x3_s2`, the JAX package's "slices" form,
bit-identical to its reduce_window form); `--pool_modes` keeps the JAX
flag, and each name runs that pool.

Every form, on the kernel route and the exact library route, is checked
bit for bit against s2d on the card at 4 crops, then at `--crops` on the
input that is timed; then one line a form gives the median of `--iters`
CUDA-event timings of the whole form on the kernel route and on the
float32 library route, in ms and crops/s, the library's buffer, im2col
and GEMM alone, and how many outputs of the float32 library route differ
from s2d's. It runs on a CUDA card only and raises without one.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models.quant import _kmat, max_pool_3x3_s2
from ..ops.conv_s8 import conv_s8, requant_reference

FORMS = ("s2d", "direct", "hfold48", "hfold24")
KERNEL_FORMS = ("s2d", "direct", "hfold48")     # the forms conv_s8 takes
POOL_MODES = ("reduce_window", "slices")
CIN_MULTIPLE = 16
REQUANT_ROWS = 1 << 21     # output pixels a float64 requant pass takes


def _pad_channels(x, c):
    """x (..., C) zero-padded to c channels."""
    if x.shape[-1] == c:
        return x.contiguous()
    out = x.new_zeros(x.shape[:-1] + (c,))
    out[..., :x.shape[-1]] = x
    return out


def _im2col(x, kh, kw, stride, dil_w, out_hw):
    """(N*Ho*Wo, K) int8 columns of an NHWC int8 tensor in (ky, kx, c)
    order, K zero-padded to a multiple of 8 (`torch._int_mm` takes such)."""
    n, _, _, c = x.shape
    ho, wo = out_hw
    k = kh * kw * c
    cols = x.new_zeros((n, ho, wo, -(-k // 8) * 8))
    taps = [x[:, ky:ky + stride * (ho - 1) + 1:stride,
              kx * dil_w:kx * dil_w + stride * (wo - 1) + 1:stride]
            for ky in range(kh) for kx in range(kw)]
    cols[..., :k] = torch.stack(taps, dim=3).reshape(n, ho, wo, k)
    return cols.reshape(n * ho * wo, -1)


def requant_float32(acc, mult, bias):
    """(M, Cout) int32 -> int8: acc * mult + bias in float32 (a rounded
    product, then the add), round half to even, clip to [0, 127]. Not
    bit-exact: the kernel rounds once, after a fused multiply-add."""
    return torch.addcmul(bias, acc.float(), mult).round_().clamp_(0, 127) \
        .to(torch.int8)


def build_variants(stem_q, stem_mult, stem_bias, pad_val, device,
                   library=False):
    """{form: fn((B, 224, 224, 3) int8 -> (B, 56, 56, 64) int8)} on
    `device`. stem_q: (7, 7, 3, 64) int8 HWIO weights; stem_mult, stem_bias:
    (64,) float32 requant; pad_val: (3,) int8 border value. The forms of
    KERNEL_FORMS run `conv_s8` (the kernel on a CUDA tensor, its plain
    version on a CPU one), hfold24 the exact library route; `library=True`
    puts every form on the exact library route. Each fn also has `gemm`
    (the buffer, im2col and `torch._int_mm`) and `float32` (the library
    route with `requant_float32`) (module docs)."""
    device = torch.device(device)
    stem_q = np.asarray(stem_q, np.int8)
    mult = torch.as_tensor(np.asarray(stem_mult, np.float32), device=device)
    bias = torch.as_tensor(np.asarray(stem_bias, np.float32), device=device)
    pad_val = torch.as_tensor(np.asarray(pad_val, np.int8), device=device)
    cin, cout = stem_q.shape[2:]

    k8 = np.zeros((8, 8, cin, cout), np.int8)
    k8[:7, :7] = stem_q
    k4 = (k8.reshape(4, 2, 4, 2, cin, cout).transpose(0, 2, 1, 3, 4, 5)
          .reshape(4, 4, 4 * cin, cout))
    # (the weights, the input channels they take, the taps, stride, W
    # dilation) of each form's convolution
    weights = {
        "s2d": (k4, (4, 4), 1, 1),
        "direct": (stem_q, (7, 7), 2, 1),
        "hfold48": (k4.reshape(4, 1, 16 * cin, cout), (4, 1), 1, 1),
        "hfold24": (k4.reshape(4, 2, 8 * cin, cout), (4, 2), 1, 2),
    }

    def dev(a):
        return torch.as_tensor(a, device=device)

    kernel_w = {name: dev(_kmat(weights[name][0], CIN_MULTIPLE))
                for name in KERNEL_FORMS}
    library_w = {}
    for name, (k, _, _, _) in weights.items():
        kt = _kmat(k).T                         # (K, Cout)
        library_w[name] = dev(np.pad(kt, ((0, -kt.shape[0] % 8), (0, 0))))

    def border(x_s8, margin):
        b, h, w, c = x_s8.shape
        buf = pad_val.expand(b, h + margin, w + margin, c).clone()
        buf[:, 3:h + 3, 3:w + 3] = x_s8
        return buf

    def space_to_depth(x_s8):
        buf = border(x_s8, 8)
        b, hp, wp, c = buf.shape
        return (buf.reshape(b, hp // 2, 2, wp // 2, 2, c)
                .permute(0, 1, 3, 2, 4, 5).reshape(b, hp // 2, wp // 2, 4 * c))

    def hfold(x2, n):
        wb = x2.shape[2]
        return torch.cat([x2[:, :, dx:wb - (n - 1) + dx] for dx in range(n)],
                         dim=-1)

    buffers = {
        "s2d": space_to_depth,
        "direct": lambda x: border(x, 6),
        "hfold48": lambda x: hfold(space_to_depth(x), 4),
        "hfold24": lambda x: hfold(space_to_depth(x), 2),
    }

    def kernel_conv(name, buf, out_hw):
        _, ksize, stride, _ = weights[name]
        return conv_s8(_pad_channels(buf, -(-buf.shape[-1] // CIN_MULTIPLE)
                                     * CIN_MULTIPLE),
                       kernel_w[name], mult, bias, ksize, stride, 0, out_hw,
                       lo=0.0, rne=True)

    def library_gemm(name, buf, out_hw):
        _, (kh, kw), stride, dil_w = weights[name]
        return torch._int_mm(_im2col(buf, kh, kw, stride, dil_w, out_hw),
                             library_w[name])

    def library_conv(name, buf, out_hw):
        acc = library_gemm(name, buf, out_hw)
        # the exact requant works in float64: a slice of rows at a time
        out = torch.empty(acc.shape, dtype=torch.int8, device=device)
        for r in range(0, acc.shape[0], REQUANT_ROWS):
            out[r:r + REQUANT_ROWS] = requant_reference(
                acc[r:r + REQUANT_ROWS], mult, bias, lo=0.0, rne=True)
        return out.reshape(buf.shape[0], *out_hw, cout)

    def float32_conv(name, buf, out_hw):
        return requant_float32(library_gemm(name, buf, out_hw), mult,
                               bias).reshape(buf.shape[0], *out_hw, cout)

    def out_hw(x_s8):
        _, h, w, _ = x_s8.shape
        return (h - 1) // 2 + 1, (w - 1) // 2 + 1

    def form(name, conv):
        def on(conv):
            return lambda x_s8: max_pool_3x3_s2(
                conv(name, buffers[name](x_s8), out_hw(x_s8)))

        run = on(conv)
        run.gemm = lambda x_s8: library_gemm(name, buffers[name](x_s8),
                                             out_hw(x_s8))
        run.float32 = on(float32_conv)
        return run

    return {name: form(name, library_conv if library
                       or name not in KERNEL_FORMS else kernel_conv)
            for name in FORMS}


def seeded_stem(rng):
    """(stem_q, stem_mult, stem_bias, pad_val) from `rng`, as the JAX tool
    draws them."""
    stem_q = rng.integers(-127, 128, (7, 7, 3, 64)).astype(np.int8)
    stem_mult = (rng.random(64).astype(np.float32) + 0.5) * 1e-3
    stem_bias = rng.standard_normal(64).astype(np.float32)
    pad_val = np.array([-14, -3, 9], np.int8)
    return stem_q, stem_mult, stem_bias, pad_val


def check_forms(variants, library, x_s8):
    """Every form on both routes bit for bit against s2d's kernel route on
    `x_s8`; raises on the first difference, else returns the output's shape."""
    ref = variants["s2d"](x_s8)
    for route, fns in (("conv_s8", variants), ("library", library)):
        for name, fn in fns.items():
            got = fn(x_s8)
            if got.shape != ref.shape:
                raise RuntimeError(f"bench_stem: {name} ({route}) gives "
                                   f"{tuple(got.shape)}, s2d "
                                   f"{tuple(ref.shape)}")
            neq = int((got != ref).sum())
            if neq:
                raise RuntimeError(f"bench_stem: {name} ({route}): {neq} "
                                   "elements differ from s2d")
    return tuple(ref.shape)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--crops", type=int, default=1120,
                   help="total crop batch (1120 = bench b112 x ten-crop)")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--pool_modes", default="reduce_window")
    args = p.parse_args(argv)
    modes = args.pool_modes.split(",")
    unknown = [m for m in modes if m not in POOL_MODES]
    if unknown:
        raise SystemExit(f"unknown pool mode(s) {unknown}; have "
                         f"{list(POOL_MODES)}")

    from .card import card_label, require_cuda, time_ms

    require_cuda("bench_stem")
    label = card_label()
    rng = np.random.default_rng(0)
    stem = seeded_stem(rng)
    print(f"backend=cuda crops={args.crops} card: {label}", flush=True)

    variants = build_variants(*stem, "cuda")
    library = build_variants(*stem, "cuda", library=True)
    small = torch.as_tensor(rng.integers(-128, 128, (4, 224, 224, 3)),
                            dtype=torch.int8, device="cuda")
    check_forms(variants, library, small)
    x = torch.as_tensor(rng.integers(-128, 128, (args.crops, 224, 224, 3)),
                        dtype=torch.int8, device="cuda")
    check_forms(variants, library, x)
    checked = [small.shape[0], args.crops]
    print(f"bit-identical: OK at {checked[0]} and {checked[1]} crops (all "
          "variants, conv_s8 and the exact library route)", flush=True)

    ref = variants["s2d"](x)
    lines = []
    for mode in modes:
        for name in FORMS:
            line = {"form": name, "pool": mode,
                    "pool_runs": "max_pool_3x3_s2 (slices)",
                    "crops": args.crops, "bit_identical_at_crops": checked}
            if name in KERNEL_FORMS:
                ms = time_ms(lambda: variants[name](x), reps=args.iters)
                line.update(conv_s8_ms=ms,
                            conv_s8_crops_per_s=args.crops / ms * 1e3)
                kernel = (f"conv_s8 {ms:7.2f} ms "
                          f"({args.crops / ms * 1e3:8.0f} crops/s)")
            else:
                line.update(conv_s8_ms=None, conv_s8="not taken (W dilation)")
                kernel = "conv_s8: not taken (W dilation)"
            lib_ms = time_ms(lambda: library[name].float32(x),
                             reps=args.iters)
            gemm_ms = time_ms(lambda: library[name].gemm(x), reps=args.iters)
            differ = int((library[name].float32(x) != ref).sum())
            line.update(library_ms=lib_ms,
                        library_crops_per_s=args.crops / lib_ms * 1e3,
                        library_gemm_ms=gemm_ms,
                        library_requant="float32, not bit-exact",
                        library_outputs_differing=differ, card=label)
            lines.append(line)
            print(f"{name:>8} pool={mode} (runs max_pool_3x3_s2, the "
                  f"slices form) {kernel}; library (float32 requant) "
                  f"{lib_ms:7.2f} ms ({args.crops / lib_ms * 1e3:8.0f} "
                  f"crops/s; buffer, im2col and _int_mm {gemm_ms:.2f} ms; "
                  f"{differ} of {ref.numel()} outputs differ)", flush=True)
            print("bench_stem " + json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()

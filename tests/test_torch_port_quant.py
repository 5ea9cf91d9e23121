"""The port's int8 path (`models/quant.py`, `models/qat.py`, the conv_s8
kernel's plain version, `eval_pipeline_s8`) against the JAX package's on the
same seeded weights and images. Host-side integer work, the requant and
every block's int8 output must match bit for bit (given the same scales);
calibration scales within 1e-4 relative (the float32 convolutions sum in
other orders); logits within a stated tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geoestimation_tpu.models.quant as jq
from geoestimation_tpu.ingest.pipeline import eval_pipeline_s8 as jax_s8
from geoestimation_tpu.models import qat as jqat
from geoestimation_tpu_torch.convert import from_jax_variables
from geoestimation_tpu_torch.ingest.pipeline import eval_pipeline_s8, shift_s8
from geoestimation_tpu_torch.models import qat as pqat
from geoestimation_tpu_torch.models import quant as pq
from geoestimation_tpu_torch.ops import conv_s8 as ops
from geoestimation_tpu_torch.tools.world import seeded_jax_variables

# resnet14's widths with a second, identity, block in layer1 and layer2:
# resnet14 itself has only stage-entry blocks
ARCH, STAGES = "resnet14_2x", (2, 2, 1, 1)
N_CLASSES = (5, 7, 11)
CROP, BASE = 64, 72
MODES = ["half_up", "rne"]


@pytest.fixture(scope="module", autouse=True)
def test_depth():
    """Registers ARCH in both packages' stage tables for this module."""
    from geoestimation_tpu.models import resnet as jax_resnet
    from geoestimation_tpu_torch.models import resnet as port_resnet

    tables = (jax_resnet.STAGE_SIZES, port_resnet.STAGE_SIZES)
    for t in tables:
        t[ARCH] = STAGES
    yield
    for t in tables:
        t.pop(ARCH)


@pytest.fixture(scope="module")
def net(test_depth):
    """Seeded weights (random BatchNorm statistics, so every fold
    does work) in both packages' forms, two base images and their crops."""
    rng = np.random.default_rng(5)
    params, stats = seeded_jax_variables(rng, ARCH, N_CLASSES)
    variables = {"params": params, "batch_stats": stats}
    sd = from_jax_variables(params, stats, ARCH, N_CLASSES)
    images = rng.integers(0, 256, (2, BASE, BASE, 3), dtype=np.uint8)
    return {"variables": variables, "sd": sd, "images": images,
            "jq": jq.quantize_model(variables, ARCH),
            "pq": pq.quantize_model(sd, ARCH)}


@pytest.fixture(scope="module")
def scales(net):
    """One scales dict (Python floats) for both sides: the JAX package's
    absmax calibration of the two images."""
    return jq.calibrate(net["variables"], [net["images"]], ARCH, n_crops=10,
                        crop=CROP)


@pytest.mark.parametrize("n_crops", [1, 5, 10])
def test_eval_pipeline_s8_bitwise(n_crops):
    u8 = np.random.default_rng(n_crops).integers(0, 256, (3, 40, 40, 3),
                                                 dtype=np.uint8)
    ref = np.asarray(jax_s8(jnp.asarray(u8), n_crops=n_crops, crop=32))
    got = eval_pipeline_s8(torch.from_numpy(u8), n_crops=n_crops, crop=32)
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(shift_s8(torch.from_numpy(u8)).numpy(),
                                  np.asarray(jq.shift_s8(jnp.asarray(u8))))


def test_quantize_model_bitwise(net):
    ref, got = net["jq"], net["pq"]
    assert got["arch"] == ref["arch"] and got["isn"] == ref["isn"] is False
    assert tuple(got["stage_sizes"]) == tuple(ref["stage_sizes"])
    for g, r in zip(got["stem"], ref["stem"]):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got["stem_pad_val"], ref["stem_pad_val"])
    assert sorted(got["blocks"]) == sorted(ref["blocks"])
    for name, qb in ref["blocks"].items():
        assert sorted(got["blocks"][name]) == sorted(qb)
        for cname, arrays in qb.items():
            for g, r in zip(got["blocks"][name][cname], arrays):
                assert g.dtype == r.dtype and g.shape == r.shape
                np.testing.assert_array_equal(g, r)
    head = ref["heads"]["heads"]["fused_head"]
    for key in ("kernel", "bias"):
        np.testing.assert_array_equal(
            got["heads"]["heads"]["fused_head"][key], np.asarray(head[key]))
    assert pq.weights_hash(got) == jq.weights_hash(ref)


def test_scales_format_matches_jax(net, scales):
    stage_sizes = pq.STAGE_SIZES[ARCH]
    assert pq.site_names(stage_sizes) == jq.site_names(stage_sizes)
    kw = dict(weights_hash="abc", source="calib_dir", n_images=7,
              stat="auto:p999", headroom=1.05, calib_fingerprint="f00",
              fast_decode=False, crop=CROP, n_crops=10, unused=None)
    packed = pq.pack_scales(scales, **kw)
    assert packed == jq.pack_scales(scales, **kw)
    for obj, expect in [(packed, "abc"), (packed, "other"), ({"version": 1},
                        None), ({**packed, "scales": {"stem": 1.0}}, None)]:
        g, r = pq.unpack_scales(obj, ARCH, expect), jq.unpack_scales(
            obj, ARCH, expect)
        assert g == r
    bad = dict(scales, stem=float("nan"))
    assert pq.scales_valid(scales, ARCH) and not pq.scales_valid(bad, ARCH)
    assert pq.unify_stage_out_scales(scales, stage_sizes) == \
        jq.unify_stage_out_scales(scales, stage_sizes)


@pytest.mark.parametrize("mode", MODES)
def test_round_like_serving_and_weight_grid_match_jax(monkeypatch, mode):
    y = (np.arange(-600, 600, dtype=np.float32) / 4).astype(np.float32)
    np.testing.assert_array_equal(
        pq.round_like_serving(torch.from_numpy(y), mode).numpy(),
        np.asarray(jq.round_like_serving(jnp.asarray(y), mode)))
    monkeypatch.setenv("GEO_WEIGHT_BITS", "4" if mode == "rne" else "8")
    assert pq.weight_qmax() == jq.weight_qmax()
    k = np.random.default_rng(2).normal(0, 0.1, (3, 3, 8, 16)).astype(
        np.float32)
    for g, r in zip(pq._quant_weight(k), jq._quant_weight(k)):
        np.testing.assert_array_equal(g, r)


# -- the requant at its rounding boundaries -----------------------------------

def _cells(fn):
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def _exact(acc, m, b, res=None, md=None):
    """fma(acc, m, b) (then fma(res, md, .)) with one rounding each, by
    the port's exact emulation; used only to aim values at boundaries."""
    y = ops.fma_f32(torch.from_numpy(acc).float(), torch.from_numpy(m),
                    torch.from_numpy(b))
    if res is not None:
        y = ops.fma_f32(torch.from_numpy(res).float(), torch.from_numpy(md), y)
    return y.numpy()


def _aim(rng, m, b, target, extra=0.0):
    """int32 accumulators putting acc * m + b + extra within a few float32
    ulps of `target` (where one rounding more or less moves the result),
    give or take one step of acc either way."""
    ulp = np.spacing(np.abs(target).astype(np.float32)).astype(np.float64)
    target = target + rng.uniform(-3, 3, np.shape(target)) * ulp
    acc = np.round((target - extra - b.astype(np.float64)) / m.astype(
        np.float64)) + rng.integers(-1, 2, target.shape)
    return np.clip(acc, -2 ** 31, 2 ** 31 - 1).astype(np.int32)


def _boundary_case(rng, rne, lo, n=20000):
    """(acc, mult, bias) whose fma lands at or within a step of the
    rounding boundaries between lo - 1 and 128: multipliers from 1e-7 (so
    |acc| passes 2^24 and its conversion rounds) to 0.5, plus exact ties
    (m = 2^-j, b = 0)."""
    m = np.exp(rng.uniform(np.log(1e-7), np.log(0.5), n)).astype(np.float32)
    b = rng.normal(0, 20, n).astype(np.float32)
    ties = rng.random(n) < 0.2
    m[ties] = 2.0 ** -rng.integers(1, 6, ties.sum())
    b[ties] = 0.0
    k = rng.integers(int(lo) - 1, 129, n).astype(np.float64)
    b_eff = b if rne else (b + np.float32(0.5))
    acc = _aim(rng, m, b_eff, k + 0.5 if rne else k)
    acc[ties] = np.round((k[ties] + 0.5 * rng.integers(0, 2, ties.sum()))
                         / m[ties]).astype(np.int32)
    return acc, m, b, b_eff


def _discriminates(y_fma, acc, m, b_eff, rne, res=None, md=None):
    """How many elements round differently when the multiply and add round
    separately (the expressions evaluated without contraction)."""
    y = (acc.astype(np.float32) * m) + b_eff
    if res is not None:
        y = y + res.astype(np.float32) * md
    r = np.round if rne else np.floor
    return int((r(y) != r(y_fma)).sum())


@pytest.mark.parametrize("lo", [0.0, -127.0])
@pytest.mark.parametrize("mode", MODES)
def test_requant_at_rounding_boundaries_bitwise(net, scales, monkeypatch,
                                                mode, lo):
    """The port's requant against the JAX package's own `requant` closure
    (taken from a built `build_int8_apply`, jitted as the engine runs it)
    on accumulators aimed at the rounding boundaries."""
    monkeypatch.setenv("GEO_REQUANT_MODE", mode)
    rne = mode == "rne"
    requant = _cells(_cells(jq.build_int8_apply(net["jq"], scales))
                     ["stem_fn"])["requant"]
    rng = np.random.default_rng(17 - int(lo) + rne)
    acc, m, b, b_eff = _boundary_case(rng, rne, lo)
    ref = np.asarray(jax.jit(lambda y, mm, bb: requant(y, mm, bb, lo))(
        acc, m, b))
    got = ops.requant_reference(torch.from_numpy(acc), torch.from_numpy(m),
                                torch.from_numpy(b_eff), lo=lo, rne=rne)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the set holds exact ties and values that only an fma rounds right
    assert _discriminates(_exact(acc, m, b_eff), acc, m, b_eff, rne) > 20
    assert (got.numpy() == lo).any() and (got.numpy() == 127).any()


def _block_with_accs(monkeypatch, jax_block):
    """jit((x, accs) -> (out, m1, m2)) of a JAX block closure whose
    convolutions give, in call order, the int32 accumulators `accs`; m1 and
    m2 are the inputs of the 2nd and 3rd convolutions, the first two
    requants' outputs. Each accumulator is an argument (not a constant,
    which XLA would fold) passed through a 1x1 identity convolution, so
    that XLA fuses each requant with its convolution's consumers as it does
    in the served graph: which products it contracts into fmas depends on
    that fusion."""
    seen, given = [], []

    def fake_conv(x, k, s=1, pad="VALID"):
        seen.append(x)
        acc = given[0][len(seen) - 1]
        eye = jnp.eye(acc.shape[-1], dtype=jnp.int32)[None, None]
        return jax.lax.conv_general_dilated(
            acc, eye, (1, 1), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)

    monkeypatch.setattr(jq, "_conv_s8", fake_conv)

    def f(x, accs):
        seen.clear()
        given[:] = [accs]
        return jax_block(x), seen[1], seen[2]

    return jax.jit(f)


@pytest.mark.parametrize("entry", [False, True], ids=["identity", "entry"])
@pytest.mark.parametrize("mode", MODES)
def test_block_requants_at_rounding_boundaries_bitwise(net, monkeypatch,
                                                       mode, entry):
    """A whole block's requant chain -- m1, m2 and the residual tail (the
    identity residual on conv3, or conv3's signed requant and the entry
    residual on the downsample conv) -- with every convolution's
    accumulators aimed at the rounding boundaries of its epilogue, against
    the JAX block closure under jit."""
    monkeypatch.setenv("GEO_REQUANT_MODE", mode)
    rne = mode == "rne"
    name = "layer2_block0" if entry else "layer1_block1"
    # scales that make the multipliers small, so |acc| passes 2^24 too
    sc = {k: 0.05 for k in jq.site_names(jq.STAGE_SIZES[ARCH])}
    s_in = "layer1_block1_out" if entry else "layer1_block0_out"
    sc.update({s_in: 0.037, f"{name}_m2": 2e-5, f"{name}_out": 0.1,
               f"{name}_y3": 0.07})
    blocks = _cells(jq.build_int8_apply(net["jq"], sc))["block_fns"]
    jax_block = blocks[1][0] if entry else blocks[0][1]
    pf = pq._prefold(net["pq"], sc)[name]
    qb = net["pq"]["blocks"][name]
    cmid, cout = qb["conv1"][0].shape[-1], qb["conv3"][0].shape[-1]
    rng = np.random.default_rng(3 + 2 * entry + rne)
    n, h = 4, 8
    ho = h // 2 if entry else h
    cin = qb["conv1"][0].shape[2]
    x = rng.integers(0, 128, (n, h, h, cin)).astype(np.int8)
    tgt = (lambda shape, lo=0: rng.integers(lo - 1, 129, shape)
           + (0.5 if rne else 0.0))
    a1 = _aim(rng, pf["m1"], pf["a1"], tgt((n, h, h, cmid)))
    a2 = _aim(rng, pf["m2"], pf["a2"], tgt((n, ho, ho, cmid)))
    if entry:
        a3 = _aim(rng, pf["m3"], pf["a3"], tgt((n, ho, ho, cout), -127))
        y3q = ops.requant_reference(torch.from_numpy(a3),
                                    torch.from_numpy(pf["m3"]),
                                    torch.from_numpy(pf["a3"]), -127.0, rne)
        ad = _aim(rng, pf["md"], pf["ad"], tgt((n, ho, ho, cout)),
                  y3q.numpy() * np.float64(pf["g3"]))
        accs = [a1, a2, a3, ad]
    else:
        a3 = _aim(rng, pf["m3"], pf["a3"], tgt((n, h, h, cout)),
                  x * np.float64(pf["md"]))
        accs = [a1, a2, a3]
    ref, ref_m1, ref_m2 = map(np.asarray, _block_with_accs(
        monkeypatch, jax_block)(jnp.asarray(x), [jnp.asarray(a) for a in accs]))

    def req(acc, m, b, **kw):
        return ops.requant_reference(torch.from_numpy(acc),
                                     torch.from_numpy(m), torch.from_numpy(b),
                                     rne=rne, **kw)

    np.testing.assert_array_equal(req(a1, pf["m1"], pf["a1"]).numpy(), ref_m1)
    np.testing.assert_array_equal(req(a2, pf["m2"], pf["a2"]).numpy(), ref_m2)
    if entry:
        got = req(ad, pf["md"], pf["ad"], res=y3q, res_scale=float(pf["g3"]),
                  res_mode="mul_add")
        res, res_scale, tail = y3q, pf["g3"], (ad, pf["md"], pf["ad"])
    else:
        got = req(a3, pf["m3"], pf["a3"], res=torch.from_numpy(x),
                  res_scale=float(pf["md"]))
        res, res_scale, tail = (torch.from_numpy(x), pf["md"],
                                (a3, pf["m3"], pf["a3"]))
    np.testing.assert_array_equal(got.numpy(), ref)
    # the other forms the tail could take each round differently on this set
    acc, m, b = (torch.from_numpy(t) for t in tail)
    fma, r, rs = ops.fma_f32, res.float(), torch.tensor(res_scale)
    product = r * rs
    others = {"fma": fma(r, rs, fma(acc.float(), m, b)),
              "mul_add": product + fma(acc.float(), m, b),
              "none": product + (acc.float() * m + b)}
    del others["mul_add" if entry else "fma"]
    rnd = torch.round if rne else torch.floor
    for form, y in others.items():
        q = rnd(y).clamp(0, 127).to(torch.int8).numpy()
        assert (q != ref).sum() >= 10, form


# -- the network, block by block ----------------------------------------------

def _jax_taps(monkeypatch, apply):
    """(jit(x -> (logits, taps)), kinds): the taps are the stem + pool
    output, every conv's input and the last block's output (the head's mean
    input), recorded where the serving graph computes them; `kinds` names
    each, filled when the function is traced."""
    taps, kinds = [], []
    conv, pool, mean = jq._conv_s8, jq.max_pool_3x3_s2, jnp.mean

    def rec_conv(x, k, s=1, pad="VALID"):
        taps.append(("conv", x))
        return conv(x, k, s, pad)

    def rec_pool(y, mode="reduce_window"):
        out = pool(y, mode)
        taps.append(("pool", out))
        return out

    def rec_mean(x, *a, **k):
        taps.append(("mean", x))
        return mean(x, *a, **k)

    monkeypatch.setattr(jq, "_conv_s8", rec_conv)
    monkeypatch.setattr(jq, "max_pool_3x3_s2", rec_pool)
    monkeypatch.setattr(jnp, "mean", rec_mean)

    def f(x):
        taps.clear()
        logits = apply(x)
        kinds[:] = [kind for kind, _ in taps]
        return logits, [t for _, t in taps]

    return jax.jit(f), kinds


@pytest.mark.parametrize("mode", MODES)
def test_stem_pool_and_every_block_bitwise(net, scales, monkeypatch, mode):
    """Given the same scales dict, the stem + max pool and every block's
    int8 output equal the JAX package's (jitted, as served) bit for bit;
    each port block is fed the JAX block's own input."""
    monkeypatch.setenv("GEO_REQUANT_MODE", mode)
    x = np.array(jax_s8(jnp.asarray(net["images"]), n_crops=10, crop=CROP))
    traced, kinds = _jax_taps(monkeypatch, jq.build_int8_apply(
        net["jq"], scales, n_classes=N_CLASSES))
    ref_logits, taps = traced(jnp.asarray(x))
    assert kinds[:2] == ["conv", "pool"] and kinds[-1] == "mean"
    taps = [np.asarray(t) for t in taps]
    block_in, i = [taps[1]], 2
    for name, _, _ in pq._block_names(STAGES):
        i += 4 if "downsample" in net["jq"]["blocks"][name] else 3
        block_in.append(taps[i])
    assert i == len(taps) - 1
    papply = pq.build_int8_apply(net["pq"], scales, n_classes=N_CLASSES,
                                 device="cpu")
    np.testing.assert_array_equal(
        papply.stem_fn(torch.from_numpy(x)).numpy(), block_in[0])
    for b, fn in enumerate(papply.block_fns):
        got = fn(torch.from_numpy(block_in[b].astype(np.int8))).numpy()
        assert got.dtype == np.int8
        # the last block's output reaches the head as float32
        np.testing.assert_array_equal(got.astype(block_in[b + 1].dtype),
                                      block_in[b + 1], err_msg=f"block {b}")
    # the whole forward's logits: the heads' bf16 products sum in another
    # order, so within float32 rounding of the sums
    for g, r in zip(papply(torch.from_numpy(x)), ref_logits):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(g.argmax(-1).numpy(),
                                      np.asarray(r).argmax(-1))


# -- calibration ------------------------------------------------------------

@pytest.mark.parametrize("stat", ["absmax", "p999", "p9999"])
def test_calibration_scales_match_jax(net, stat):
    batches = [net["images"][:1], net["images"][1:]]
    ref = jq.calibrate(net["variables"], batches, ARCH, n_crops=5, crop=CROP,
                       stat=stat, headroom=1.1)
    got = pq.calibrate(net["sd"], batches, ARCH, n_crops=5, crop=CROP,
                       stat=stat, headroom=1.1, device="cpu")
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-4), k


def test_calibrate_samples_and_derive_scales_match_jax(net):
    ref = jq.calibrate_samples(net["variables"], [net["images"]], ARCH,
                               n_crops=10, crop=CROP, n_cap=1 << 10)
    got = pq.calibrate_samples(net["sd"], [net["images"]], ARCH, n_crops=10,
                               crop=CROP, n_cap=1 << 10, device="cpu")
    assert got.keys() == ref.keys()
    for k, (m, pool) in ref.items():
        assert got[k][0] == pytest.approx(float(m), rel=1e-4)
        # the same subsample (NHWC order), up to float32 rounding
        assert got[k][1].shape == pool.shape
        np.testing.assert_allclose(got[k][1], pool, rtol=1e-3, atol=1e-4)
    for stat in pq.AUTO_CANDIDATE_STATS:
        g, r = pq.derive_scales(got, stat, 1.2), jq.derive_scales(ref, stat,
                                                                  1.2)
        for k in r:
            assert g[k] == pytest.approx(r[k], rel=1e-4), (stat, k)
        # derive_scales itself is host numpy: identical on identical input
        assert pq.derive_scales(ref, stat, 1.2) == r


def test_teacher_and_kl_match_jax(net, scales):
    x = np.asarray(jax_s8(jnp.asarray(net["images"]), n_crops=10, crop=CROP))
    ref = jax.jit(jqat.build_qat_apply(ARCH, scales, n_classes=N_CLASSES,
                                       fake_quant=False))(
        jqat.fold_variables(net["variables"], ARCH), x.astype(np.float32))
    got = pqat.build_qat_apply(ARCH, scales, n_classes=N_CLASSES,
                               fake_quant=False)(
        pqat.fold_variables(net["sd"], ARCH), torch.from_numpy(x).float())
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)
    student = [r + np.float32(0.3) * np.asarray(r)[::-1] for r in ref]
    assert float(pqat.teacher_student_kl(
        [torch.from_numpy(np.asarray(r)) for r in ref],
        [torch.from_numpy(np.asarray(s)) for s in student])) == pytest.approx(
        float(jqat.teacher_student_kl(ref, student)), rel=1e-5)


def test_autoselect_pick_matches_jax(net):
    """`--calib_stat auto` picks JAX's statistic (unless the KLs lie within
    1e-6), with the same scales. From the same samples, the scored KLs agree within
    1e-3 relative (the int8 students are bitwise equal; the float32
    teachers differ in summation order); from each package's own float32
    calibration within 2e-2: the scales differ by float32 rounding, which
    moves a few int8 activations by one step."""
    batches = [net["images"]]
    samples = jq.calibrate_samples(net["variables"], batches, arch=ARCH,
                                   n_crops=10, crop=CROP)
    kw = dict(arch=ARCH, n_classes=N_CLASSES, n_crops=10, crop=CROP)
    r_scales, r_pick, r_kls = jq.autoselect_scales(
        net["variables"], batches, net["jq"], samples=samples, **kw)
    g_scales, g_pick, g_kls = pq.autoselect_scales(
        net["sd"], batches, net["pq"], samples=samples, device="cpu", **kw)
    assert g_scales == r_scales
    best = sorted(r_kls.values())
    for s in pq.AUTO_CANDIDATE_STATS:
        assert g_kls[s] == pytest.approx(r_kls[s], rel=1e-3), s
    if best[1] - best[0] > 1e-6:
        assert g_pick == r_pick
    own_scales, own_pick, own_kls = pq.autoselect_scales(
        net["sd"], batches, net["pq"], device="cpu", **kw)
    for s in pq.AUTO_CANDIDATE_STATS:
        assert own_kls[s] == pytest.approx(r_kls[s], rel=2e-2), s
    if best[1] - best[0] > 1e-6:
        assert own_pick == r_pick
    for k in r_scales:
        assert own_scales[k] == pytest.approx(r_scales[k], rel=1e-4), k


def test_build_int8_pipeline_matches_jax(net):
    images = net["images"]
    ref = jq.build_int8_pipeline(net["variables"], [images], ARCH,
                                 n_classes=N_CLASSES, n_crops=5, crop=CROP)
    got = pq.build_int8_pipeline(net["sd"], [images], ARCH,
                                 n_classes=N_CLASSES, n_crops=5, crop=CROP,
                                 device="cpu")
    for k in ref.scales:
        assert got.scales[k] == pytest.approx(ref.scales[k], rel=1e-4)
    out = got(torch.from_numpy(images))
    assert [tuple(o.shape) for o in out] == [(10, n) for n in N_CLASSES]


# -- what the port refuses ---------------------------------------------------

def test_not_ported_options_raise(net, scales, monkeypatch):
    """QAT and the TPU probe still raise by name. `feature_tta` and ISN
    heads, refused here until ported, now build as in the JAX package: a
    feature-TTA forward of the base images, and an ISN net's routed heads
    (tests/test_torch_port_tta.py and test_torch_port_isn.py hold both to
    the JAX package bit for bit)."""
    feature = pq.build_int8_apply(net["pq"], scales, n_classes=N_CLASSES,
                                  device="cpu",
                                  feature_tta={"crop": CROP, "n_crops": 5})
    rng = np.random.default_rng(9)
    # the crop grid on the layer3 map: (base - crop) a multiple of 32
    base = shift_s8(torch.from_numpy(rng.integers(
        0, 256, (2, CROP + 32, CROP + 32, 3), dtype=np.uint8)))
    assert [tuple(o.shape) for o in feature(base)] == [
        (10, n) for n in N_CLASSES]
    isn_heads = {"scene_head": {"kernel": rng.normal(
                     0, 0.05, (2048, 3)).astype(np.float32),
                     "bias": np.zeros(3, np.float32)},
                 "scene_geo_heads": {"kernel": rng.normal(
                     0, 0.05, (2048, 3 * sum(N_CLASSES))).astype(np.float32),
                     "bias": np.zeros(3 * sum(N_CLASSES), np.float32)}}
    isn = pq.build_int8_apply({**net["pq"], "isn": True, "heads": isn_heads},
                              scales, n_classes=N_CLASSES, device="cpu")
    x = torch.from_numpy(np.array(jax_s8(jnp.asarray(net["images"]),
                                         n_crops=1, crop=CROP)))
    assert [tuple(o.shape) for o in isn(x)] == [(2, n) for n in N_CLASSES]
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        pqat.build_qat_apply(ARCH, scales, fake_quant=True)
    monkeypatch.setenv("GEO_REQUANT_PROBE", "trunc")
    with pytest.raises(NotImplementedError, match="GEO_REQUANT_PROBE"):
        pq.build_int8_apply(net["pq"], scales, device="cpu")


def test_odd_crop_is_refused(net, scales):
    apply = pq.build_int8_apply(net["pq"], scales, device="cpu")
    with pytest.raises(ValueError, match="even crop dims"):
        apply(torch.zeros((1, 63, 64, 3), dtype=torch.int8))


# -- the kernel's wrapper on the CPU --------------------------------------------

def _conv_case(rng, n, h, cin, cout, k, stride, pad, res=False):
    x = torch.from_numpy(rng.integers(-128, 128, (n, h, h, cin)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (cout, k * k * cin)).astype(
        np.int8))
    mult = torch.from_numpy(rng.uniform(1e-4, 1e-2, cout).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 5, cout).astype(np.float32))
    ho, wo = ops.out_size(h, h, (k, k), stride, pad)
    r = (torch.from_numpy(rng.integers(-127, 128, (n, ho, wo, cout)).astype(
        np.int8)) if res else None)
    return x, w, mult, bias, r


@pytest.mark.parametrize("k, stride, pad", [(1, 1, 0), (3, 1, 1), (3, 2, 1),
                                            (1, 2, 0), (4, 1, 0)])
def test_conv_s8_plain_version_against_jax_conv(k, stride, pad):
    """The plain version's exact accumulators equal XLA's s8 x s8 -> s32
    convolution (`_conv_s8`); on a CPU tensor the wrapper is the plain
    version and counts no launch."""
    rng = np.random.default_rng(k + 3 * stride)
    x, w, mult, bias, _ = _conv_case(rng, 2, 9, 32, 24, k, stride, pad)
    kq = w.numpy().reshape(24, k, k, 32).transpose(1, 2, 3, 0)
    ref = np.asarray(jq._conv_s8(jnp.asarray(x.numpy()), jnp.asarray(kq),
                                 s=stride, pad=((pad, pad), (pad, pad))))
    acc = ops.conv_acc_reference(x, w, (k, k), stride, pad, ref.shape[1:3])
    np.testing.assert_array_equal(acc.numpy(), ref)
    before = ops.conv_s8.launches
    got = ops.conv_s8(x, w, mult, bias, (k, k), stride, pad, rne=True)
    np.testing.assert_array_equal(
        got.numpy(), ops.requant_reference(acc, mult, bias, rne=True).numpy())
    assert ops.conv_s8.launches == before


def test_conv_s8_refuses_what_it_does_not_take():
    rng = np.random.default_rng(0)
    x, w, mult, bias, r = _conv_case(rng, 1, 6, 16, 8, 3, 1, 1, res=True)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ops.conv_s8(x.to("meta"), w.to("meta"), mult.to("meta"),
                    bias.to("meta"), (3, 3), 1, 1)
    with pytest.raises(TypeError, match="w must be torch.int8"):
        ops.conv_s8(x, w.float(), mult, bias, (3, 3), 1, 1)
    with pytest.raises(ValueError, match="res must have shape"):
        ops.conv_s8(x, w, mult, bias, (3, 3), 2, 1, res=r)
    with pytest.raises(ValueError, match="w must have shape"):
        ops.conv_s8(x, w, mult, bias, (1, 1))
    with pytest.raises(ValueError, match="out_hw"):
        ops.conv_s8(x, w, mult, bias, (3, 3), 1, 1, out_hw=(7, 6))


@pytest.mark.parametrize("n, refused", [
    (5120, False),       # 512 images x 10 crops: a stem output of 4.1 GB
    (-(-ops.MAX_PIXELS // (112 * 112)), True),
], ids=["ten_crop_batch_512", "pixels_at_the_limit"])
def test_conv_s8_kernel_size_limit(monkeypatch, n, refused):
    """The wrapper passes large ten-crop batches on to the kernel (its byte
    offsets are 64-bit) and refuses, naming the limit, only N*Ho*Wo past
    int32's reach."""
    class Launching(Exception):
        pass

    def load(name):
        raise Launching(name)

    monkeypatch.setattr(ops._build, "load", load)
    x, w = torch.zeros(16, dtype=torch.int8), torch.zeros(16, dtype=torch.int8)
    mult, bias = torch.zeros(64), torch.zeros(64)
    dims = (n, 116, 116, 16, 112, 112, 64)
    args = (x, w, mult, bias, None, dims, (4, 4), 1, 0, 0.0, False, 0.0, "fma")
    if refused:
        with pytest.raises(ValueError, match=f"N\\*Ho\\*Wo < {ops.MAX_PIXELS}"):
            ops._launch(*args)
    else:
        with pytest.raises(Launching):
            ops._launch(*args)

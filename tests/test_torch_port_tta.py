"""The port's TTA variants against the JAX package's, on the same seeded
weights and images (resnet14, 64-px bases, 32-px crops): feature-space TTA
in bf16 (the fast path, with the fused kernel's plain version against the
Pallas kernel in interpret mode, and without) and in int8 (every int8
activation bit for bit, logits within float32 rounding), the W-mirrored
network and mirror TTA, and the engine's `tta_mode="feature"`."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geoestimation_tpu.models.quant as jq
from geoestimation_tpu.ingest.pipeline import normalize as jax_normalize
from geoestimation_tpu.models import fast_infer as jax_fast
from geoestimation_tpu_torch.convert import from_jax_variables
from geoestimation_tpu_torch.ingest.pipeline import (
    eval_pipeline,
    normalize,
    shift_s8,
)
from geoestimation_tpu_torch.models import fast_infer as port_fast
from geoestimation_tpu_torch.models import quant as pq
from geoestimation_tpu_torch.tools.world import seeded_jax_variables

ARCH = "resnet14"
N_CLASSES = (5, 7, 11)
BASE, CROP = 64, 32
# the fast path's gates (tests/test_torch_port_model.py): with the fused
# kernel (its plain version against Pallas in interpret mode), and without
TOL = {True: dict(rtol=0.15, atol=0.2), False: dict(rtol=0.1, atol=0.15)}


@pytest.fixture(scope="module")
def net():
    """Seeded weights (random BatchNorm statistics) in both packages'
    forms and two base images."""
    rng = np.random.default_rng(17)
    params, stats = seeded_jax_variables(rng, ARCH, N_CLASSES)
    variables = {"params": params, "batch_stats": stats}
    images = rng.integers(0, 256, (2, BASE, BASE, 3), dtype=np.uint8)
    return {"variables": variables, "images": images,
            "sd": from_jax_variables(params, stats, ARCH, N_CLASSES)}


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX fast path's stride-1 Pallas kernel in interpret mode."""
    jfb = importlib.import_module("geoestimation_tpu.ops.fused_bottleneck")
    monkeypatch.setattr(
        jax_fast, "fused_bottleneck",
        lambda *a, **k: jfb.fused_bottleneck(*a, **{**k, "interpret": True}))


def _close(got, ref, use_pallas):
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.dtype == np.float32 and g.shape == r.shape
        np.testing.assert_allclose(g, r, **TOL[use_pallas])
        np.testing.assert_array_equal(g.argmax(-1), r.argmax(-1))


# -- bf16 feature TTA ----------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True], ids=["conv", "kernel"])
@pytest.mark.parametrize("level", [1, 2, 3])
def test_feature_tta_matches_jax(net, level, use_pallas, request):
    if use_pallas:
        request.getfixturevalue("pallas_interpret")
    u8 = net["images"]
    ref = jax_fast.build_feature_tta_apply(
        net["variables"], ARCH, n_classes=N_CLASSES, use_pallas=use_pallas,
        crop=CROP, level=level)(jax_normalize(jnp.asarray(u8), jnp.bfloat16))
    apply = port_fast.build_feature_tta_apply(
        net["sd"], ARCH, n_classes=N_CLASSES, use_pallas=use_pallas,
        crop=CROP, level=level, device="cpu")
    with torch.inference_mode():
        got = apply(normalize(torch.from_numpy(u8), torch.bfloat16))
    assert [tuple(g.shape) for g in got] == [(20, n) for n in N_CLASSES]
    _close(got, ref, use_pallas)


def test_five_crop_is_the_ten_crop_prefix(net):
    """tests/test_feature_tta.py's contract: the five-crop windows are the
    first five of each image's ten."""
    x = normalize(torch.from_numpy(net["images"]), torch.bfloat16)
    out = {}
    for n in (5, 10):
        with torch.inference_mode():
            out[n] = port_fast.build_feature_tta_apply(
                net["sd"], ARCH, n_classes=N_CLASSES, crop=CROP, n_crops=n,
                device="cpu")(x)
    for ten, five in zip(out[10], out[5]):
        torch.testing.assert_close(ten.reshape(2, 10, -1)[:, :5],
                                   five.reshape(2, 5, -1), rtol=0, atol=1e-3)


@pytest.mark.parametrize("case", ["misaligned", "not_square", "level_0",
                                  "level_4", "one_crop"])
@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_feature_tta_refusals_match_jax(net, case, precision):
    """The same ValueError, with the same message, from both packages."""
    kw = {"misaligned": {}, "not_square": {}, "level_0": {"level": 0},
          "level_4": {"level": 4}, "one_crop": {"n_crops": 1}}[case]
    shape = {"misaligned": (1, 48, 48, 3),
             "not_square": (1, 64, 48, 3)}.get(case, (1, BASE, BASE, 3))
    if precision == "bf16":
        def jax_apply():
            return jax_fast.build_feature_tta_apply(
                net["variables"], ARCH, crop=CROP, **kw)(
                jnp.zeros(shape, jnp.bfloat16))

        def port_apply():
            return port_fast.build_feature_tta_apply(
                net["sd"], ARCH, crop=CROP, device="cpu", **kw)(
                torch.zeros(shape, dtype=torch.bfloat16))
    else:
        scales = {k: 0.05 for k in jq.site_names(jq.STAGE_SIZES[ARCH])}
        ft = {"crop": CROP, **kw}

        def jax_apply():
            return jq.build_int8_apply(jq.quantize_model(net["variables"],
                                                         ARCH), scales,
                                       feature_tta=ft)(
                jnp.zeros(shape, jnp.int8))

        def port_apply():
            return pq.build_int8_apply(pq.quantize_model(net["sd"], ARCH),
                                       scales, feature_tta=ft, device="cpu")(
                torch.zeros(shape, dtype=torch.int8))
    with pytest.raises(ValueError) as want:
        jax_apply()
    with pytest.raises(ValueError) as got:
        port_apply()
    assert str(got.value) == str(want.value)


# -- int8 feature TTA ----------------------------------------------------------

@pytest.fixture(scope="module")
def int8_nets(net):
    scales = jq.calibrate(net["variables"], [net["images"]], ARCH,
                          n_crops=10, crop=CROP)
    return (jq.quantize_model(net["variables"], ARCH),
            pq.quantize_model(net["sd"], ARCH), scales)


def _jax_last_map(monkeypatch, apply):
    """A jitted `apply` that also returns the int8 map its head pools (the
    input of the head's jnp.mean)."""
    mean, taps = jnp.mean, []

    def rec_mean(x, *a, **k):
        taps.append(x)
        return mean(x, *a, **k)

    monkeypatch.setattr(jnp, "mean", rec_mean)

    def f(x):
        taps.clear()
        return apply(x), taps[-1]

    return jax.jit(f)


@pytest.mark.parametrize("level", [2, 3])
def test_int8_feature_tta_bitwise(net, int8_nets, monkeypatch, level):
    """Given the same scales, the map the head pools equals the JAX
    package's bit for bit; the logits within float32 rounding (the head's
    bf16 products sum in another order)."""
    jnet, pnet, scales = int8_nets
    ft = {"crop": CROP, "n_crops": 10, "level": level}
    u8 = net["images"]
    ref, ref_map = _jax_last_map(monkeypatch, jq.build_int8_apply(
        jnet, scales, n_classes=N_CLASSES, feature_tta=ft))(
        jq.shift_s8(jnp.asarray(u8)))
    apply = pq.build_int8_apply(pnet, scales, n_classes=N_CLASSES,
                                feature_tta=ft, device="cpu")
    base = shift_s8(torch.from_numpy(u8))
    got = apply(base)
    # the forward's pieces: trunk, windows, the rest per window
    x = port_fast.ftta_mirror_concat(base, 10)
    for fn in apply.stage_fns[:1 + level]:
        x = fn(x)
    xc = port_fast.ftta_windows(x, 2, BASE, CROP, 10, level)
    assert xc.is_contiguous()
    for fn in apply.stage_fns[1 + level:]:
        xc = fn(xc)
    np.testing.assert_array_equal(xc.float().numpy(), np.asarray(ref_map))
    for g, r in zip(got, ref):
        assert g.shape == (20, r.shape[-1])
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(g.argmax(-1).numpy(),
                                      np.asarray(r).argmax(-1))


# -- the mirrored network and mirror TTA ----------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True], ids=["conv", "kernel"])
def test_mirrored_network_matches_jax(net, use_pallas, request):
    """netM against the JAX package's netM, and against the port's net on
    the flipped images stage by stage (flip_W(net(flip_W(x))) at every
    stage output): an off-by-one-column padding would show there."""
    if use_pallas:
        request.getfixturevalue("pallas_interpret")
    x = np.array(jax_normalize(jnp.asarray(net["images"]), jnp.float32))
    ref = jax_fast.build_fast_apply(net["variables"], ARCH,
                                    n_classes=N_CLASSES, use_pallas=use_pallas,
                                    mirror=True)(jnp.asarray(x))
    kw = dict(n_classes=N_CLASSES, use_pallas=use_pallas, device="cpu")
    mirrored = port_fast.build_fast_apply(net["sd"], ARCH, mirror=True, **kw)
    plain = port_fast.build_fast_apply(net["sd"], ARCH, **kw)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        _close(mirrored(xt), ref, use_pallas)
        a, b = xt, xt.flip(2)
        for fm, fp in zip(mirrored.stage_fns, plain.stage_fns):
            a, b = fm(a), fp(b)
            torch.testing.assert_close(a.float(), b.flip(3).float(),
                                       rtol=0.05, atol=0.05)
        for g, r in zip(mirrored.head_logits(a), plain.head_logits(b)):
            torch.testing.assert_close(g, r, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("n_crops", [5, 10])
def test_mirror_tta_matches_jax_and_ten_crop(net, pallas_interpret, n_crops):
    """Five crops through net and netM against the JAX package's mirror
    TTA, and against the port's fast path on the ten (or five) pixel crops
    (tests/test_fast_infer.py's 0.05)."""
    u8 = np.random.default_rng(3).integers(0, 256, (2, 72, 72, 3),
                                           dtype=np.uint8)
    ref = jax_fast.build_mirror_tta_apply(
        net["variables"], ARCH, n_classes=N_CLASSES, crop=64,
        n_crops=n_crops)(jnp.asarray(u8))
    kw = dict(n_classes=N_CLASSES, device="cpu")
    apply = port_fast.build_mirror_tta_apply(net["sd"], ARCH, crop=64,
                                             n_crops=n_crops, **kw)
    with torch.inference_mode():
        got = apply(torch.from_numpy(u8))
        crops = port_fast.build_fast_apply(net["sd"], ARCH, **kw)(
            eval_pipeline(torch.from_numpy(u8), n_crops=n_crops, crop=64))
    assert [tuple(g.shape) for g in got] == [(2 * n_crops, n)
                                             for n in N_CLASSES]
    _close(got, ref, True)
    for g, r in zip(got, crops):
        torch.testing.assert_close(g, r, rtol=0.05, atol=0.05)


# -- the engine ----------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_world(net, geo_parts, tmp_path_factory):
    from geoestimation_tpu.utils.config import Config as JaxConfig

    from geoestimation_tpu_torch.geo import load_partitionings
    from geoestimation_tpu_torch.utils.config import Config

    d = tmp_path_factory.mktemp("ftta_parts")
    files = []
    for p in geo_parts:
        files.append(str(d / f"{p.name}.csv"))
        p.to_csv(files[-1])
    n_classes = [len(p) for p in geo_parts]
    params, stats = seeded_jax_variables(np.random.default_rng(23), ARCH,
                                         n_classes)
    configs = []
    for cls in (JaxConfig, Config):
        c = cls()
        c.model_params.arch = ARCH
        c.model_params.partitionings.files = files
        configs.append(c)
    return {"jax": (configs[0], {"params": params, "batch_stats": stats},
                    geo_parts),
            "port": (configs[1], from_jax_variables(params, stats, ARCH,
                                                    n_classes),
                     load_partitionings(files,
                                        names=[p.name for p in geo_parts])),
            # as many distinct images as a first-batch calibration needs to
            # be written to the scales cache
            "images": np.random.default_rng(29).integers(
                0, 256, (6, BASE, BASE, 3), dtype=np.uint8)}


def _jax_engine(world, **kw):
    from geoestimation_tpu.eval.engine import InferenceEngine as JaxEngine

    config, state, parts = world["jax"]
    return JaxEngine(config, state, partitionings=parts, n_crops=10,
                     crop=CROP, tta_mode="feature", feature_tta_level=2,
                     **kw)


def _port_engine(world, **kw):
    from geoestimation_tpu_torch.eval.engine import InferenceEngine

    config, sd, parts = world["port"]
    return InferenceEngine(config, sd, partitionings=parts, n_crops=10,
                           crop=CROP, tta_mode="feature",
                           feature_tta_level=2, device="cpu", **kw)


def test_engine_feature_tta_bf16(engine_world):
    """`tta_mode="feature"` in bf16 with the kernel's plain version: the
    engine's per-crop logits are build_feature_tta_apply's, and its
    predictions the JAX engine's in the same mode."""
    eng = _port_engine(engine_world, use_pallas=True)
    u8 = torch.from_numpy(engine_world["images"])
    apply = port_fast.build_feature_tta_apply(
        engine_world["port"][1], ARCH,
        n_classes=[len(p) for p in eng.partitionings], use_pallas=True,
        crop=CROP, level=2, device="cpu")
    with torch.inference_mode():
        want = apply(normalize(u8, torch.bfloat16))
    for g, r in zip(eng.crop_logits(u8), want):
        assert torch.equal(g, r)
    ref = _jax_engine(engine_world).predict_batch(engine_world["images"])
    got = eng.predict_batch(engine_world["images"])
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key][0], ref[key][0], err_msg=key)


def test_engine_feature_tta_int8_matches_jax(engine_world, tmp_path):
    """int8 `tta_mode="feature"`: the port calibrates on the first batch's
    crops (absmax) and writes the scales cache; the JAX engine takes that
    file as its own; the predictions are equal."""
    import shutil

    kw = dict(int8=True, calib_stat="absmax")
    eng = _port_engine(engine_world, int8_scales_path=str(
        tmp_path / "port.json"), **kw)
    got = eng.predict_batch(engine_world["images"])
    assert eng.int8_calib_source == "first_batch"
    shutil.copy(tmp_path / "port.json", tmp_path / "jax.json")
    jax_eng = _jax_engine(engine_world, int8_scales_path=str(
        tmp_path / "jax.json"), **kw)
    ref = jax_eng.predict_batch(engine_world["images"])
    assert jax_eng.int8_calib_source == "cache"
    for key in ref:
        np.testing.assert_array_equal(got[key][0], ref[key][0], err_msg=key)
        np.testing.assert_allclose(got[key][1], ref[key][1], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("kw", [dict(dtype="float32"), dict(n_crops=1)],
                         ids=["precision32", "one_crop"])
def test_engine_feature_tta_refusals_match_jax(engine_world, tmp_path, kw):
    from geoestimation_tpu.eval.engine import InferenceEngine as JaxEngine

    from geoestimation_tpu_torch.eval.engine import InferenceEngine

    jc, state, jparts = engine_world["jax"]
    pc, sd, pparts = engine_world["port"]
    jkw, pkw = dict(kw), dict(kw)
    if "dtype" in kw:
        jkw["dtype"], pkw["dtype"] = jnp.float32, torch.float32
    common = dict(crop=CROP, tta_mode="feature")
    with pytest.raises(ValueError) as want:
        JaxEngine(jc, state, partitionings=jparts, **common, **jkw)
    with pytest.raises(ValueError) as got:
        InferenceEngine(pc, sd, partitionings=pparts, device="cpu", **common,
                        **pkw)
    assert str(got.value) == str(want.value)

"""The port's ISN (scene-gated heads, `models/isn.py`) against the JAX
package's on the same seeded weights (resnet14): the module with and without
scene labels, the weights bridge, the fast path's routed head, the int8 path
(every activation bit for bit, the routed logits within float32 rounding),
its float32 teacher, the weights hash, the engine in every mode, and the
inference CLI's CSV on an ISN orbax checkpoint."""

import importlib
import importlib.util
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import geoestimation_tpu.models.quant as jq
from geoestimation_tpu.ingest.pipeline import eval_pipeline_s8 as jax_s8
from geoestimation_tpu.ingest.pipeline import normalize as jax_normalize
from geoestimation_tpu.models import fast_infer as jax_fast
from geoestimation_tpu.models import qat as jqat
from geoestimation_tpu.models.isn import ISNClassifier as JaxISN
from geoestimation_tpu_torch.convert import from_jax_variables
from geoestimation_tpu_torch.models import fast_infer as port_fast
from geoestimation_tpu_torch.models import qat as pqat
from geoestimation_tpu_torch.models import quant as pq
from geoestimation_tpu_torch.models.isn import ISNClassifier
from geoestimation_tpu_torch.tools.world import seeded_jax_variables

ARCH = "resnet14"
N_CLASSES = (5, 7, 11)
N_SCENES = 3
SIZE = 64


@pytest.fixture(scope="module")
def net():
    """Seeded ISN weights in both packages' forms, and six images."""
    rng = np.random.default_rng(31)
    params, stats = seeded_jax_variables(rng, ARCH, N_CLASSES, N_SCENES)
    u8 = rng.integers(0, 256, (6, SIZE, SIZE, 3), dtype=np.uint8)
    return {"variables": {"params": params, "batch_stats": stats},
            "sd": from_jax_variables(params, stats, ARCH, N_CLASSES),
            "u8": u8,
            "x": np.array(jax_normalize(jnp.asarray(u8), jnp.float32))}


def _module(net, dtype):
    model = ISNClassifier(N_CLASSES, N_SCENES, ARCH, dtype)
    model.load_state_dict(net["sd"], strict=True)
    return model.eval()


@pytest.mark.parametrize("scene", [False, True], ids=["argmax", "labels"])
def test_module_matches_jax(net, scene):
    """float32: the routed logits, and `with_scene`'s scene logits and
    per-scene heads, against the JAX ISNClassifier."""
    jmodel = JaxISN(n_classes=N_CLASSES, n_scenes=N_SCENES, arch=ARCH,
                    dtype=jnp.float32)
    labels = np.arange(len(net["x"])) % N_SCENES
    kw = {"scene": jnp.asarray(labels)} if scene else {}
    ref = jmodel.apply(net["variables"], jnp.asarray(net["x"]), train=False,
                       **kw)
    ref_scene, ref_heads = jmodel.apply(net["variables"],
                                        jnp.asarray(net["x"]),
                                        method=jmodel.with_scene)
    model = _module(net, torch.float32)
    x = torch.from_numpy(net["x"])
    with torch.inference_mode():
        got = model(x, scene=torch.from_numpy(labels) if scene else None)
        scene_logits, heads = model.with_scene(x)
    np.testing.assert_allclose(scene_logits.numpy(), np.asarray(ref_scene),
                               rtol=1e-4, atol=1e-4)
    for g, r in zip(heads + got, list(ref_heads) + list(ref)):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)
    if not scene:
        labels = scene_logits.argmax(-1).numpy()
    for g, h in zip(got, heads):
        np.testing.assert_array_equal(
            g.numpy(), h.numpy()[np.arange(len(labels)), labels])


def test_bridge_round_trip(net):
    """from_jax_variables -> state dict -> the reference importer's backbone
    and transposed heads give the original arrays bit for bit."""
    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "import_torch_checkpoint.py")
    spec = importlib.util.spec_from_file_location("import_torch_checkpoint",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    sd = {k: v.numpy() for k, v in net["sd"].items()}
    params, stats = tool.convert_backbone(tool.strip_prefixes(sd), ARCH)
    for got, want in ((params, net["variables"]["params"]["backbone"]),
                      (stats, net["variables"]["batch_stats"]["backbone"])):
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_want = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        for (_, g), (_, w) in zip(flat_got, flat_want):
            np.testing.assert_array_equal(g, w)
    for name in ("scene_head", "scene_geo_heads"):
        want = net["variables"]["params"][name]
        np.testing.assert_array_equal(sd[f"{name}.weight"].T, want["kernel"])
        np.testing.assert_array_equal(sd[f"{name}.bias"], want["bias"])
    assert sd["scene_geo_heads.weight"].shape == (
        N_SCENES * sum(N_CLASSES), 2048)
    assert not any(k.startswith("heads.") for k in sd)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["conv", "kernel"])
def test_fast_path_isn_head_matches_jax(net, use_pallas, monkeypatch):
    """The fast path's routed ISN head (bf16 features and weights, float32
    sums) against the JAX fast path's, with the fused kernel's plain version
    against Pallas in interpret mode, or neither."""
    if use_pallas:
        jfb = importlib.import_module("geoestimation_tpu.ops.fused_bottleneck")
        monkeypatch.setattr(jax_fast, "fused_bottleneck", lambda *a, **k:
                            jfb.fused_bottleneck(*a, **{**k,
                                                        "interpret": True}))
    ref = jax_fast.build_fast_apply(net["variables"], ARCH,
                                    n_classes=N_CLASSES,
                                    use_pallas=use_pallas)(
        jnp.asarray(net["x"]))
    apply = port_fast.build_fast_apply(net["sd"], ARCH, n_classes=N_CLASSES,
                                       use_pallas=use_pallas, device="cpu")
    with torch.inference_mode():
        got = apply(torch.from_numpy(net["x"]))
    tol = dict(rtol=0.15, atol=0.2) if use_pallas else dict(rtol=0.1,
                                                            atol=0.15)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **tol)
        np.testing.assert_array_equal(g.argmax(-1).numpy(),
                                      np.asarray(r).argmax(-1))


# -- int8 ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def int8_nets(net):
    scales = jq.calibrate(net["variables"], [net["u8"]], ARCH, n_crops=1,
                          crop=SIZE)
    return (jq.quantize_model(net["variables"], ARCH),
            pq.quantize_model(net["sd"], ARCH), scales)


def test_quantize_model_keeps_isn_heads(int8_nets):
    """The JAX package's layout of the heads, the same arrays, and the
    same weights hash (over the backbone's int8 weights only)."""
    jnet, pnet, _ = int8_nets
    assert pnet["isn"] is jnet["isn"] is True
    assert sorted(pnet["heads"]) == sorted(jnet["heads"]) == [
        "scene_geo_heads", "scene_head"]
    for name, head in jnet["heads"].items():
        for key in ("kernel", "bias"):
            np.testing.assert_array_equal(pnet["heads"][name][key],
                                          np.asarray(head[key]))
    assert pq.weights_hash(pnet) == jq.weights_hash(jnet)


def test_int8_isn_bitwise(net, int8_nets, monkeypatch):
    """Given the same scales, the map the head pools equals the JAX
    package's bit for bit; the routed logits within float32 rounding."""
    jnet, pnet, scales = int8_nets
    x = np.array(jax_s8(jnp.asarray(net["u8"]), n_crops=1, crop=SIZE))
    mean, taps = jnp.mean, []
    monkeypatch.setattr(jnp, "mean", lambda v, *a, **k: (
        taps.append(v), mean(v, *a, **k))[1])

    def f(v):
        taps.clear()
        return jq.build_int8_apply(jnet, scales, n_classes=N_CLASSES)(v), \
            taps[-1]

    ref, ref_map = jax.jit(f)(jnp.asarray(x))
    apply = pq.build_int8_apply(pnet, scales, n_classes=N_CLASSES,
                                device="cpu")
    xt = torch.from_numpy(x)
    last = xt
    for fn in apply.stage_fns:
        last = fn(last)
    np.testing.assert_array_equal(last.float().numpy(), np.asarray(ref_map))
    for g, r in zip(apply(xt), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(g.argmax(-1).numpy(),
                                      np.asarray(r).argmax(-1))


def test_teacher_isn_head_matches_jax(net, int8_nets):
    """The float32 teacher `autoselect_scales` scores against: its routed
    ISN head."""
    _, _, scales = int8_nets
    x = np.asarray(jax_s8(jnp.asarray(net["u8"]), n_crops=1, crop=SIZE))
    ref = jax.jit(jqat.build_qat_apply(ARCH, scales, n_classes=N_CLASSES,
                                       fake_quant=False))(
        jqat.fold_variables(net["variables"], ARCH), x.astype(np.float32))
    folded = pqat.fold_variables(net["sd"], ARCH)
    assert sorted(folded["heads"]) == ["scene_geo_heads", "scene_head"]
    got = pqat.build_qat_apply(ARCH, scales, n_classes=N_CLASSES,
                               fake_quant=False)(
        folded, torch.from_numpy(x).float())
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)


# -- the engine and the CLI on an ISN orbax checkpoint ----------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """An ISN resnet14 checkpoint in both packages' formats (orbax, and the
    port's directory from it), three partitionings and three JPEGs."""
    from PIL import Image

    from geoestimation_tpu.geo import create_cells
    from geoestimation_tpu.train.checkpoint import (
        load_for_inference,
        save_single,
    )
    from geoestimation_tpu.utils.config import Config as JaxConfig

    from geoestimation_tpu_torch.checkpoint import save_checkpoint
    from geoestimation_tpu_torch.utils.config import load_config

    root = tmp_path_factory.mktemp("isn_world")
    rng = np.random.default_rng(37)
    lat = np.concatenate([48.85 + rng.normal(0, .4, 1500),
                          40.7 + rng.normal(0, .4, 1500)])
    lng = np.concatenate([2.35 + rng.normal(0, .4, 1500),
                          -74.0 + rng.normal(0, .4, 1500)])
    files, counts = [], []
    for img_max, name in [(2000, "coarse"), (700, "middle"), (300, "fine")]:
        part = create_cells(lat, lng, img_min=10, img_max=img_max,
                            name=name).partitioning
        files.append(str(root / f"{name}.csv"))
        part.to_csv(files[-1])
        counts.append(len(part))
    config = JaxConfig()
    config.model_params.arch = ARCH
    config.model_params.partitionings.files = files
    config.model_params.scene_gating = True
    params, stats = seeded_jax_variables(rng, ARCH, counts, N_SCENES)
    jax_ckpt = str(root / "jax_ckpt")
    save_single(jax_ckpt, {"params": params, "batch_stats": stats},
                config=config, step=0, metrics={"val_loss": 1.0})
    cfg, restored = load_for_inference(jax_ckpt)
    port_ckpt = str(root / "port_ckpt")
    save_checkpoint(port_ckpt, from_jax_variables(
        restored["params"], restored["batch_stats"], ARCH, counts),
        load_config(os.path.join(jax_ckpt, "hparams.yaml")))
    img_dir = root / "images"
    img_dir.mkdir()
    for i in range(3):
        arr = rng.integers(0, 255, (280 + 10 * i, 260, 3), dtype=np.uint8)
        Image.fromarray(arr).save(img_dir / f"img_{i:03d}.jpg", quality=90)
    return {"jax": jax_ckpt, "port": port_ckpt, "images": str(img_dir),
            "config": cfg, "restored": restored}


@pytest.fixture
def jax_pil_decode(monkeypatch):
    """Both packages decode through PIL, so both see the same pixels."""
    monkeypatch.setattr("geoestimation_tpu.ingest.native.available",
                        lambda: False)
    monkeypatch.setattr("geoestimation_tpu_torch.ingest.native.available",
                        lambda: False)


# engine keywords of each mode, in both packages (dtype filled in)
MODES = {
    "module": dict(fast=False),
    "fast": dict(fast=True, use_pallas=True),
    "host_exact": dict(fast=True, use_pallas=True, tta_mode="host_exact"),
    "feature": dict(tta_mode="feature", use_pallas=True, n_crops=5),
    "int8": dict(int8=True, calib_stat="absmax"),
    "int8_feature": dict(int8=True, calib_stat="absmax", tta_mode="feature",
                         n_crops=5),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_serves_isn_in_every_mode(world, mode, tmp_path,
                                         monkeypatch):
    """An ISN checkpoint through each of the engine's paths, at 64-px
    crops of 96-px bases: the port's predictions against the JAX engine's
    in the same mode (its Pallas kernel in interpret mode; int8 on the same
    scales: the port's cache, read by the JAX engine)."""
    jfb = importlib.import_module("geoestimation_tpu.ops.fused_bottleneck")
    monkeypatch.setattr(jax_fast, "fused_bottleneck", lambda *a, **k:
                        jfb.fused_bottleneck(*a, **{**k, "interpret": True}))
    from geoestimation_tpu.eval.engine import InferenceEngine as JaxEngine
    from geoestimation_tpu.geo import load_partitionings as jax_parts

    from geoestimation_tpu_torch.checkpoint import load_checkpoint
    from geoestimation_tpu_torch.eval.engine import InferenceEngine
    from geoestimation_tpu_torch.geo import load_partitionings

    kw = dict(MODES[mode])
    kw.setdefault("n_crops", 10)
    files = world["config"].model_params.partitionings.files
    names = ["coarse", "middle", "fine"]
    rng = np.random.default_rng(41)
    images = rng.integers(0, 256, (6, 96, 96, 3), dtype=np.uint8)
    if mode == "host_exact":
        images = rng.integers(0, 256, (2, 10, 64, 64, 3), dtype=np.uint8)
    int8 = kw.get("int8", False)
    config, sd = load_checkpoint(world["port"])
    port = InferenceEngine(config, sd, partitionings=load_partitionings(
        files, names=names), crop=64, device="cpu",
        **({"int8_scales_path": str(tmp_path / "port.json")} if int8
           else {}), **kw)
    got = port.predict_batch(images)
    if int8:
        shutil.copy(tmp_path / "port.json", tmp_path / "jax.json")
        kw["int8_scales_path"] = str(tmp_path / "jax.json")
    ref_engine = JaxEngine(world["config"], world["restored"],
                           partitionings=jax_parts(files, names=names),
                           crop=64, **kw)
    ref = ref_engine.predict_batch(images)
    if int8:
        assert ref_engine.int8_calib_source == "cache"
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key][0], ref[key][0], err_msg=key)


def _cli_csv(main, ckpt, images, out, extra):
    main(["--checkpoint", ckpt, "--image_dir", images, "--output", str(out),
          "--batch_size", "3", "--crops", "1", "--cpu"] + extra)
    return pd.read_csv(out)


@pytest.mark.parametrize("precision", ["16", "8"])
def test_inference_cli_isn_matches_jax(world, tmp_path, jax_pil_decode,
                                       precision):
    """Both inference CLIs on the ISN orbax world: bf16 gives the same
    predicted classes; int8 (the port calibrates on the images and writes
    its cache, which the JAX CLI takes as its own) the same rows."""
    from classification.inference import main as jax_main

    from geoestimation_tpu_torch.classification.inference import main

    extra = ["--precision", precision]
    if precision == "8":
        extra += ["--calib_dir", world["images"], "--calib_images", "3",
                  "--calib_stat", "absmax"]
    cache = "int8_scales.json"
    for ckpt in (world["jax"], world["port"]):
        if os.path.exists(os.path.join(ckpt, cache)):
            os.remove(os.path.join(ckpt, cache))
    got = _cli_csv(main, world["port"], world["images"], tmp_path / "p.csv",
                   extra)
    if precision == "8":
        prov = json.load(open(os.path.join(world["port"], cache)))
        assert prov["provenance"]["source"] == "calib_dir"
        shutil.copy(os.path.join(world["port"], cache),
                    os.path.join(world["jax"], cache))
    ref = _cli_csv(jax_main, world["jax"], world["images"],
                   tmp_path / "j.csv", extra)
    assert list(got.columns) == list(ref.columns) and len(got) == len(ref) \
        == 3 * 4
    assert (got.img_id == ref.img_id).all() and (got.p_key == ref.p_key).all()
    np.testing.assert_array_equal(got.pred_class, ref.pred_class)
    if precision == "8":
        np.testing.assert_allclose(got.pred_lat, ref.pred_lat, rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got.pred_lng, ref.pred_lng, rtol=0,
                                   atol=1e-5)

"""The port's host side, eval math, engine and CLIs against the JAX
package's, plus the port's import hygiene. Host-side numpy and integer work
must match bit for bit; float32 device math within float32 rounding."""

import ast
import io
import os
import pathlib
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from geoestimation_tpu.data import image_folder as jax_folder
from geoestimation_tpu.eval import infer as jax_infer
from geoestimation_tpu.eval import metrics as jax_metrics
from geoestimation_tpu.geo import Hierarchy as JaxHierarchy
from geoestimation_tpu.ingest import decode as jax_decode
from geoestimation_tpu.ingest.pipeline import eval_pipeline as jax_pipeline
from geoestimation_tpu_torch.data import image_folder as port_folder
from geoestimation_tpu_torch.eval import infer as port_infer
from geoestimation_tpu_torch.eval import metrics as port_metrics
from geoestimation_tpu_torch.geo import Hierarchy, load_partitionings
from geoestimation_tpu_torch.ingest import decode as port_decode
from geoestimation_tpu_torch.ingest.pipeline import eval_pipeline

REPO = pathlib.Path(__file__).resolve().parent.parent
RNG = np.random.default_rng(21)


@pytest.fixture(scope="module")
def port_parts(geo_parts, tmp_path_factory):
    """The shared JAX partitionings, written to CSV and read by the port."""
    d = tmp_path_factory.mktemp("cells")
    paths = []
    for p in geo_parts:
        path = str(d / f"{p.name}.csv")
        p.to_csv(path)
        paths.append(path)
    return load_partitionings(paths, names=[p.name for p in geo_parts])


def test_hierarchy_matches_jax(geo_parts, port_parts):
    ref, got = JaxHierarchy.build(geo_parts), Hierarchy.build(port_parts)
    assert len(got.maps) == len(ref.maps)
    for g, r in zip(got.maps, ref.maps):
        np.testing.assert_array_equal(g, r)
        assert g.dtype == r.dtype
    np.testing.assert_array_equal(got.valid, ref.valid)
    for g, r in zip(got.partitionings, ref.partitionings):
        np.testing.assert_array_equal(g.lat, r.lat)
        np.testing.assert_array_equal(g.lng, r.lng)
        np.testing.assert_array_equal(g.cell_ids, r.cell_ids)


@pytest.mark.parametrize("n_crops", [1, 5, 10])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_pipeline_bitwise(n_crops, dtype):
    u8 = RNG.integers(0, 256, (2, 40, 40, 3), dtype=np.uint8)
    ref = jax_pipeline(jnp.asarray(u8), n_crops=n_crops, crop=32,
                       dtype=getattr(jnp, dtype))
    got = eval_pipeline(torch.from_numpy(u8), n_crops=n_crops, crop=32,
                        dtype=getattr(torch, dtype))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_tta_folds_and_f_star_match_jax(geo_parts, port_parts):
    n_crops, b = 10, 3
    harrays_j = jax_infer.HierarchyArrays.from_hierarchy(
        JaxHierarchy.build(geo_parts))
    harrays_p = port_infer.HierarchyArrays.from_hierarchy(
        Hierarchy.build(port_parts))
    logits = [RNG.normal(0, 3, (b * n_crops, len(p))).astype(np.float32)
              for p in geo_parts]
    for fold in port_infer.TTA_FOLDS:
        ref = [jax_infer.mean_tta_logits(jnp.asarray(l), n_crops, fold)
               for l in logits]
        got = [port_infer.mean_tta_logits(torch.from_numpy(l), n_crops, fold)
               for l in logits]
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                       atol=1e-5)
        preds_j = jax_infer.predict_all(ref, harrays_j)
        preds_p = port_infer.predict_all(got, harrays_p)
        assert sorted(preds_j) == sorted(preds_p)
        for key in preds_j:
            for g, r in zip(preds_p[key], preds_j[key]):
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_allclose(
            port_infer.hierarchical_log_probs(got, harrays_p).numpy(),
            np.asarray(jax_infer.hierarchical_log_probs(ref, harrays_j)),
            rtol=1e-5, atol=1e-5)


def test_gcd_counts_match_jax():
    n = 64
    true_lat, pred_lat = RNG.uniform(-60, 70, (2, n)).astype(np.float32)
    true_lng, pred_lng = RNG.uniform(-180, 180, (2, n)).astype(np.float32)
    pred_lat[:8] = true_lat[:8] + RNG.normal(0, 0.01, 8).astype(np.float32)
    pred_lng[:8] = true_lng[:8]
    valid = RNG.random(n) > 0.2
    for v in (None, valid):
        ref_c, ref_t = jax_metrics.gcd_threshold_counts(
            pred_lat, pred_lng, true_lat, true_lng, valid=v)
        got_c, got_t = port_metrics.gcd_threshold_counts(
            pred_lat, pred_lng, true_lat, true_lng, valid=v)
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
        assert got_t == int(ref_t)
    np.testing.assert_allclose(
        port_metrics.great_circle_distance(pred_lat, pred_lng, true_lat,
                                           true_lng).numpy(),
        np.asarray(jax_metrics.great_circle_distance(pred_lat, pred_lng,
                                                     true_lat, true_lng)),
        rtol=1e-5, atol=1e-3)


def _image_blob(h, w, fmt):
    buf = io.BytesIO()
    Image.fromarray(RNG.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
        buf, format=fmt, quality=90)
    return buf.getvalue()


@pytest.mark.parametrize("fast_scale", [False, True])
def test_decode_matches_jax_pil_path(fast_scale):
    blobs = [_image_blob(300, 260, "JPEG"), _image_blob(700, 900, "JPEG"),
             _image_blob(256, 256, "PNG"), b"not an image"]
    ref, ref_ok = jax_decode.decode_batch(blobs, backend="pil",
                                          fast_scale=fast_scale)
    got, got_ok = port_decode.decode_batch(blobs, backend="pil",
                                           fast_scale=fast_scale)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_ok, ref_ok)
    assert got_ok.tolist() == [True, True, True, False]


# -- end to end: a JAX checkpoint converted for the port, both CLIs ----------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from geoestimation_tpu.geo import create_cells, load_partitionings as jlp
    from geoestimation_tpu.train.checkpoint import (
        load_for_inference,
        save_single,
    )
    from geoestimation_tpu.train.init import init_model_state
    from geoestimation_tpu.utils.config import Config

    from geoestimation_tpu_torch.checkpoint import save_checkpoint
    from geoestimation_tpu_torch.convert import from_jax_variables
    from geoestimation_tpu_torch.utils.config import load_config

    root = tmp_path_factory.mktemp("world")
    rng = np.random.default_rng(11)
    lat = np.concatenate([48.85 + rng.normal(0, .4, 2500),
                          40.7 + rng.normal(0, .4, 2500)])
    lng = np.concatenate([2.35 + rng.normal(0, .4, 2500),
                          -74.0 + rng.normal(0, .4, 2500)])
    files = []
    for img_max, name in [(3000, "coarse"), (1000, "middle"), (400, "fine")]:
        path = str(root / f"{name}.csv")
        create_cells(lat, lng, img_min=10, img_max=img_max,
                     name=name).partitioning.to_csv(path)
        files.append(path)
    config = Config()
    config.model_params.arch = "resnet14"
    config.model_params.partitionings.files = files
    parts = jlp(files, names=["coarse", "middle", "fine"])
    _, state = init_model_state(config, parts, seed=0, image_size=64)
    jax_ckpt = str(root / "jax_ckpt")
    save_single(jax_ckpt, state, config=config, step=0,
                metrics={"val_loss": 1.0})

    cfg, restored = load_for_inference(jax_ckpt)
    sd = from_jax_variables(restored["params"], restored["batch_stats"],
                            cfg.model_params.arch, [len(p) for p in parts])
    port_ckpt = str(root / "port_ckpt")
    save_checkpoint(port_ckpt, sd,
                    load_config(os.path.join(jax_ckpt, "hparams.yaml")))

    img_dir = root / "images"
    img_dir.mkdir()
    meta = []
    for i in range(7):
        arr = rng.integers(0, 255, (300 + 10 * i, 260, 3), dtype=np.uint8)
        Image.fromarray(arr).save(img_dir / f"img_{i:03d}.jpg", quality=90)
        meta.append((f"img_{i:03d}.jpg", 48.85 + 0.01 * i, 2.35))
    meta.append(("not_in_dir.jpg", 0.0, 0.0))
    pd.DataFrame(meta, columns=["IMG_ID", "LAT", "LON"]).to_csv(
        root / "meta.csv", index=False)
    return {"jax": jax_ckpt, "port": port_ckpt, "images": str(img_dir),
            "meta": str(root / "meta.csv"), "root": root}


@pytest.fixture
def jax_pil_decode(monkeypatch):
    """Both packages decode through PIL, so both sides see the same pixels
    whichever native decoder is built."""
    monkeypatch.setattr("geoestimation_tpu.ingest.native.available",
                        lambda: False)
    monkeypatch.setattr("geoestimation_tpu_torch.ingest.native.available",
                        lambda: False)


@pytest.fixture(scope="module")
def jax_native_so(tmp_path_factory):
    from tests.test_torch_port_ingest import build_jax_native

    return build_jax_native(tmp_path_factory.mktemp("jax_ingest"))


@pytest.fixture(params=["pil", "default"])
def decoder(request):
    """'pil': both sides pinned to PIL (jax_pil_decode); 'default': each
    side on its own `auto` backend, the native decoder of each where it
    builds. Both sides must resolve to the same backend."""
    from tests.test_torch_port_ingest import jax_native_from

    if request.param == "pil":
        request.getfixturevalue("jax_pil_decode")
        assert port_decode.auto_backend() == "pil"
        yield "pil"
        return
    with jax_native_from(request.getfixturevalue("jax_native_so")) as native:
        assert port_decode.auto_backend() == "turbo", \
            port_decode.native.build_error()
        assert native.available()
        yield "turbo"


def test_config_schema_matches_jax(world, tmp_path):
    import dataclasses

    from geoestimation_tpu.train.checkpoint import read_hparams
    from geoestimation_tpu_torch.utils.config import load_config

    path = os.path.join(world["jax"], "hparams.yaml")
    assert dataclasses.asdict(load_config(path)) == dataclasses.asdict(
        read_hparams(world["jax"]))
    bad = tmp_path / "bad.yaml"
    bad.write_text("model_params:\n  arch: resnet50\n  no_such_key: 1\n")
    with pytest.raises(ValueError, match="unknown config key"):
        load_config(str(bad))


def test_image_folder_and_meta_match_jax(world, jax_pil_decode):
    ref = list(jax_folder.iter_image_folder(world["images"], batch_size=4))
    got = list(port_folder.iter_image_folder(world["images"], batch_size=4))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g.ids == r.ids
        np.testing.assert_array_equal(g.images, r.images)
        np.testing.assert_array_equal(g.valid, r.valid)
    pd.testing.assert_frame_equal(port_folder.load_meta_csv(world["meta"]),
                                  jax_folder.load_meta_csv(world["meta"]))


TTA_CASES = [pytest.param("pil", [], id="pil-device_tta"),
             pytest.param("default", [], id="default-device_tta"),
             pytest.param("default", ["--exact_tta"], id="default-exact_tta")]


@pytest.mark.parametrize("decoder, tta", TTA_CASES, indirect=["decoder"])
def test_inference_cli_matches_jax_fp32(world, tmp_path, decoder, tta):
    """Both CLIs at fp32 on the world's non-square images; --exact_tta is
    the host ten-crop, decoded through PIL on both sides."""
    from classification.inference import main as jax_main

    from geoestimation_tpu_torch.classification.inference import main

    common = ["--image_dir", world["images"], "--batch_size", "4",
              "--crops", "10", "--precision", "32", "--cpu"] + tta
    jax_main(["--checkpoint", world["jax"], "--output",
              str(tmp_path / "jax.csv")] + common)
    main(["--checkpoint", world["port"], "--output",
          str(tmp_path / "port.csv")] + common)
    ref = pd.read_csv(tmp_path / "jax.csv")
    got = pd.read_csv(tmp_path / "port.csv")
    assert list(got.columns) == list(ref.columns)
    assert len(got) == len(ref) == 7 * 4
    assert (got.img_id == ref.img_id).all() and (got.p_key == ref.p_key).all()
    np.testing.assert_array_equal(got.pred_class, ref.pred_class)
    np.testing.assert_allclose(got.pred_lat, ref.pred_lat, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.pred_lng, ref.pred_lng, rtol=0, atol=1e-5)


@pytest.mark.parametrize("decoder, tta", TTA_CASES, indirect=["decoder"])
def test_test_cli_matches_jax_fp32(world, tmp_path, decoder, tta):
    from classification.test import main as jax_main

    from geoestimation_tpu_torch.classification.test import main

    common = ["--image_dirs", world["images"], "--meta_files", world["meta"],
              "--batch_size", "4", "--crops", "1", "--precision", "32",
              "--cpu"] + tta
    ref = jax_main(["--checkpoint", world["jax"]] + common)
    got = main(["--checkpoint", world["port"], "--json",
                str(tmp_path / "acc.json")] + common)
    assert got.keys() == ref.keys()
    for name in ref:
        assert got[name].keys() == ref[name].keys()
        for key, accs in ref[name].items():
            if key.startswith("_"):
                assert got[name][key] == accs
                continue
            assert list(got[name][key]) == list(accs)
            np.testing.assert_allclose(list(got[name][key].values()),
                                       list(accs.values()), rtol=0, atol=1e-6)
    assert (tmp_path / "acc.json").exists()


@pytest.mark.parametrize("tta", [[], ["--exact_tta"]],
                         ids=["device_tta", "exact_tta"])
def test_inference_cli_fast_kernel_path_on_cpu(world, tmp_path, tta):
    """--fast --pallas through the CLI: the folded path with the kernel's
    plain version on the CPU gives the module path's classes, on device
    crops and on the host's exact ten-crops."""
    from geoestimation_tpu_torch.classification.inference import main

    common = ["--checkpoint", world["port"], "--image_dir", world["images"],
              "--batch_size", "8", "--crops", "1", "--cpu"] + tta
    main(common + ["--output", str(tmp_path / "fast.csv"), "--fast",
                   "--pallas"])
    main(common + ["--output", str(tmp_path / "module.csv")])
    fast = pd.read_csv(tmp_path / "fast.csv")
    module = pd.read_csv(tmp_path / "module.csv")
    assert len(fast) == 7 * 4
    np.testing.assert_array_equal(fast.pred_class, module.pred_class)


@pytest.mark.parametrize("flags", [
    ["--precision", "8", "--feature_tta"], ["--feature_tta"],
    ["--feature_tta_level", "2"], ["--num_processes", "2"],
    ["--coordinator", "localhost:1234"],
])
def test_cli_refuses_flags_not_ported(world, flags, tmp_path,
                                      jax_pil_decode):
    """The multi-process flags, refused here until multi-process eval was
    ported, are parsed as the JAX CLI parses them: an orphan --num_processes
    exits with the JAX CLI's message, and --coordinator HOST:PORT without
    the process flags exits naming them (tests/test_torch_port_multiprocess_
    eval.py runs the flags in two processes). The feature-TTA flags, refused
    here until the TTA variants were ported, do what the JAX CLI does with
    them on the same checkpoint and images: --feature_tta gives its
    predicted classes (bf16), and with --precision 8 its rows on the same
    scales (the port's calib_dir cache, which the JAX CLI takes as its
    own); --feature_tta_level alone changes nothing."""
    from classification.inference import main as jax_main

    from geoestimation_tpu_torch.classification.inference import main

    common = ["--image_dir", world["images"], "--cpu"] + flags
    if "--num_processes" in flags:
        messages = []
        for run, ckpt in ((jax_main, world["jax"]), (main, world["port"])):
            with pytest.raises(SystemExit) as e:
                run(["--checkpoint", ckpt] + common)
            messages.append(str(e.value))
        assert messages[1] == messages[0] == \
            "--num_processes/--process_id require --coordinator"
        return
    if "--coordinator" in flags:
        with pytest.raises(SystemExit, match="needs --num_processes and "
                                             "--process_id"):
            main(["--checkpoint", world["port"]] + common)
        return
    int8 = "8" in flags
    common += ["--batch_size", "8"]
    if int8:
        common += ["--crops", "5", "--calib_dir", world["images"],
                   "--calib_images", "2", "--calib_stat", "absmax"]
    caches = [os.path.join(world[k], "int8_scales.json")
              for k in ("port", "jax")]
    try:
        main(["--checkpoint", world["port"], "--output",
              str(tmp_path / "port.csv")] + common)
        if int8:
            shutil.copy(caches[0], caches[1])
        jax_main(["--checkpoint", world["jax"], "--output",
                  str(tmp_path / "jax.csv")] + common)
    finally:
        for path in caches:
            if os.path.exists(path):
                os.remove(path)
    ref = pd.read_csv(tmp_path / "jax.csv")
    got = pd.read_csv(tmp_path / "port.csv")
    assert len(got) == len(ref) == 7 * 4
    assert (got.img_id == ref.img_id).all() and (got.p_key == ref.p_key).all()
    np.testing.assert_array_equal(got.pred_class, ref.pred_class)
    if int8:
        np.testing.assert_allclose(got.pred_lat, ref.pred_lat, rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got.pred_lng, ref.pred_lng, rtol=0,
                                   atol=1e-5)


def test_cli_runs_on_cuda_unless_asked_for_cpu(world, monkeypatch):
    from geoestimation_tpu_torch.classification.inference import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--checkpoint", world["port"], "--image_dir", world["images"]])


# -- import hygiene ------------------------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "geoestimation_tpu")


def _port_files():
    return sorted((REPO / "geoestimation_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def test_port_imports_no_jax_ast():
    files = _port_files()
    pkg = REPO / "geoestimation_tpu_torch"
    assert {pkg / "parallel" / "multihost.py",
            pkg / "parallel" / "mesh.py", pkg / "models" / "qat.py",
            pkg / "models" / "tta_distill.py",
            pkg / "tools" / "qat_finetune.py",
            pkg / "tools" / "tta_distill.py",
            pkg / "tools" / "quant_study.py",
            pkg / "tools" / "reproduce_tables.py",
            pkg / "geo" / "create_cells.py", pkg / "geo" / "native.py",
            pkg / "partitioning" / "create_cells.py",
            pkg / "partitioning" / "assign_classes.py",
            pkg / "tools" / "make_demo_world.py",
            pkg / "tools" / "download_images.py",
            pkg / "tools" / "filter_by_downloaded_images.py"} <= set(files)
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_port_imports_no_jax_at_runtime():
    code = f"""
import importlib, pkgutil, sys
before = set(sys.modules)
import geoestimation_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
sys.path.insert(0, {str(REPO)!r})
import chip_smoke
added = set(sys.modules) - before
bad = sorted(m for m in added if m.split(".")[0] in {FORBIDDEN!r})
assert not bad, bad
print(len(added))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr

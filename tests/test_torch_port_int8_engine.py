"""The port's int8 engine, CLIs and server (`--precision 8`) against the JAX
package's: the CLIs' CSV rows and GCD tables on the same world and the same
scales, the scales cache's trust rules and its exchange between the two
packages, host-precropped (`--exact_tta`) input, and the server's synthetic
warmup."""

import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

import geoestimation_tpu.models.quant as jq
import geoestimation_tpu_torch.models.quant as pq
from geoestimation_tpu_torch.eval.engine import (
    InferenceEngine,
    default_scales_path,
)
from tests.torch_port_world import NEW_YORK, PARIS, clustered_world
from tests.torch_port_world import one_thread_no_tensorboard  # noqa: F401

CACHE = "int8_scales.json"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A resnet14 checkpoint in both packages' formats, with seeded weights
    and BatchNorm statistics (so every fold does work), three partitionings
    of clustered points, 7 non-square JPEGs and their meta CSV."""
    return clustered_world(tmp_path_factory, seed=11,
                           centers=(PARIS, NEW_YORK), n_per_center=2500,
                           img_maxes=(3000, 1000, 400), n_images=7)


@pytest.fixture
def jax_pil_decode(monkeypatch):
    """Both packages decode through PIL, so both see the same pixels."""
    monkeypatch.setattr("geoestimation_tpu.ingest.native.available",
                        lambda: False)
    monkeypatch.setattr("geoestimation_tpu_torch.ingest.native.available",
                        lambda: False)


def _subset(world, tmp_path_factory, n):
    d = tmp_path_factory.mktemp(f"images{n}")
    names = sorted(os.listdir(world["images"]))[:n]
    for name in names:
        shutil.copy(os.path.join(world["images"], name), d / name)
    meta = pd.read_csv(world["meta"])
    meta[meta.IMG_ID.isin(names)].to_csv(d / "meta.csv", index=False)
    return {"images": str(d), "meta": str(d / "meta.csv"), "n": n}


@pytest.fixture(scope="module")
def few(world, tmp_path_factory):
    """Three of the world's images and their meta rows: every path of the
    CLIs (batches of 2 and 1), small enough for the JAX package's int8
    forward on the CPU (XLA's s8 convolutions there take about 0.75 s a
    224-px crop)."""
    return _subset(world, tmp_path_factory, 3)


@pytest.fixture(scope="module")
def one(world, tmp_path_factory):
    """One image: its ten host crops are one batch."""
    return _subset(world, tmp_path_factory, 1)


@pytest.fixture
def clean_caches(world):
    """No scales cache in either checkpoint before or after the test."""
    paths = [os.path.join(world[k], CACHE) for k in ("jax", "port")]

    def clean():
        for p in paths:
            if os.path.exists(p):
                os.remove(p)

    clean()
    yield paths
    clean()


def _boom(*a, **k):
    raise AssertionError("calibration ran despite a valid scales cache")


def _no_calibration(monkeypatch, module):
    for name in ("calibrate", "calibrate_samples", "autoselect_scales"):
        monkeypatch.setattr(module, name, _boom)


def _same_rows(got_csv, ref_csv, n_rows):
    ref, got = pd.read_csv(ref_csv), pd.read_csv(got_csv)
    assert list(got.columns) == list(ref.columns) and len(got) == len(ref) \
        == n_rows
    assert (got.img_id == ref.img_id).all() and (got.p_key == ref.p_key).all()
    np.testing.assert_array_equal(got.pred_class, ref.pred_class)
    np.testing.assert_allclose(got.pred_lat, ref.pred_lat, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.pred_lng, ref.pred_lng, rtol=0, atol=1e-5)


def _calib_args(few, crops):
    """--precision 8 calibrated on the images themselves at a fixed
    statistic (one float32 pass; 'auto' is held to the JAX package in
    test_torch_port_quant.py and below)."""
    return ["--precision", "8", "--calib_dir", few["images"],
            "--calib_images", str(few["n"]), "--calib_stat", "absmax",
            "--batch_size", str(min(few["n"], 2)), "--crops", str(crops),
            "--cpu"]


def test_inference_cli_int8_reads_jax_scales_and_matches(
        world, few, tmp_path, clean_caches, jax_pil_decode,
        monkeypatch, capsys):
    """The JAX CLI calibrates on --calib_dir and writes its cache; the port
    takes that file as its own (no calibration runs) and writes the JAX
    CLI's CSV rows."""
    from classification.inference import main as jax_main

    from geoestimation_tpu_torch.classification.inference import main

    args = ["--image_dir", few["images"]] + _calib_args(few, 1)
    jax_main(["--checkpoint", world["jax"], "--output",
              str(tmp_path / "jax.csv")] + args)
    jax_cache, port_cache = clean_caches
    prov = json.load(open(jax_cache))["provenance"]
    assert (prov["source"], prov["stat"]) == ("calib_dir", "absmax")
    shutil.copy(jax_cache, port_cache)
    _no_calibration(monkeypatch, pq)
    capsys.readouterr()
    main(["--checkpoint", world["port"], "--output",
          str(tmp_path / "port.csv")] + args)
    assert "ignoring scales cache" not in capsys.readouterr().out
    _same_rows(tmp_path / "port.csv", tmp_path / "jax.csv", few["n"] * 4)


def test_exact_tta_int8_jax_reads_port_scales_and_matches(
        world, one, tmp_path, clean_caches, jax_pil_decode,
        monkeypatch):
    """`--exact_tta --precision 8`: host ten-crops (5-D batches) through the
    int8 path. The port calibrates on --calib_dir and writes the cache; the
    JAX CLI takes the port's file as its own and writes the same rows."""
    from classification.inference import main as jax_main

    from geoestimation_tpu_torch.classification.inference import main

    args = ["--image_dir", one["images"], "--exact_tta"] + _calib_args(
        one, 10)
    main(["--checkpoint", world["port"], "--output",
          str(tmp_path / "port.csv")] + args)
    jax_cache, port_cache = clean_caches
    prov = json.load(open(port_cache))["provenance"]
    assert (prov["source"], prov["n_crops"], prov["n_images"]) == (
        "calib_dir", 10, 1)
    shutil.copy(port_cache, jax_cache)
    _no_calibration(monkeypatch, jq)
    jax_main(["--checkpoint", world["jax"], "--output",
              str(tmp_path / "jax.csv")] + args)
    _same_rows(tmp_path / "port.csv", tmp_path / "jax.csv", 4)


def test_test_cli_int8_matches_jax(world, few, tmp_path,
                                   clean_caches, jax_pil_decode,
                                   monkeypatch):
    """The GCD tables of both test CLIs at --precision 8 on the same
    scales (the port's calibration, read back by both)."""
    from classification.test import main as jax_main

    from geoestimation_tpu_torch.classification.test import main

    args = ["--image_dirs", few["images"], "--meta_files",
            few["meta"]] + _calib_args(few, 1)
    got = main(["--checkpoint", world["port"]] + args)
    jax_cache, port_cache = clean_caches
    shutil.copy(port_cache, jax_cache)
    _no_calibration(monkeypatch, jq)
    ref = jax_main(["--checkpoint", world["jax"]] + args)
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


# -- the scales cache: trust rules --------------------------------------------

CROP, BASE = 64, 72


@pytest.fixture(scope="module")
def tiny(world):
    """The world's weights and partitionings at 64-px crops, and 8 distinct
    base images."""
    from geoestimation_tpu_torch.checkpoint import load_checkpoint
    from geoestimation_tpu_torch.geo import load_partitionings

    config, sd = load_checkpoint(world["port"])
    parts = load_partitionings(config.model_params.partitionings.files,
                               names=list(
                                   config.model_params.partitionings.shortnames))
    images = np.random.default_rng(4).integers(0, 256, (8, BASE, BASE, 3),
                                               dtype=np.uint8)
    return config, sd, parts, images


def _engine(tiny, path, **kw):
    config, sd, parts, _ = tiny
    return InferenceEngine(config, sd, partitionings=parts, n_crops=1,
                           crop=CROP, device="cpu", int8=True,
                           int8_scales_path=str(path), **kw)


@pytest.fixture(scope="module")
def first_batch(tiny):
    """The engine's first-batch calibration of `tiny`'s 8 images (absmax,
    as `_engine(..., calib_stat="absmax")` calls it), computed once, and a
    valid cache of it: the template each trust rule changes."""
    config, sd, _, images = tiny
    arch = config.model_params.arch
    scales = pq.calibrate(sd, [images], arch, n_crops=1, crop=CROP,
                          stat="absmax", headroom=1.0, device="cpu")
    cache = pq.pack_scales(scales, weights_hash=pq.weights_hash(
        pq.quantize_model(sd, arch)), source="first_batch", n_images=8,
        stat="absmax", fast_decode=False, crop=CROP, n_crops=1)
    return scales, cache


def _valid_cache(first_batch, **prov):
    obj = json.loads(json.dumps(first_batch[1]))
    obj["provenance"].update(prov)
    return obj


def _calibrated_once(monkeypatch, tiny, first_batch):
    """`pq.calibrate` on `tiny`'s batch at the engine's absmax arguments
    gives `first_batch`'s scales without another float32 pass; any other
    call calibrates."""
    calibrate = pq.calibrate

    def once(sd, batches, arch, **kw):
        if (sd is tiny[1] and len(batches) == 1
                and np.array_equal(batches[0], tiny[3])
                and kw == dict(n_crops=1, crop=CROP, stat="absmax",
                               headroom=1.0, device="cpu")):
            return dict(first_batch[0])
        return calibrate(sd, batches, arch, **kw)

    monkeypatch.setattr(pq, "calibrate", once)


# (what is changed in a valid cache, whether the engine trusts it)
CACHE_CASES = {
    "valid": ({}, True),
    "stale_weights_hash": ({"weights_hash": "0000000000000000"}, False),
    "other_pixel_pipeline": ({"crop": 224}, False),
    "other_settings": ({"stat": "p999"}, False),
    "other_headroom": ({"headroom": 1.05}, False),
    "trained_qat_at_other_settings": ({"source": "qat", "stat": "p999",
                                       "crop": 224}, True),
    "legacy_format": (None, False),
}


@pytest.mark.parametrize("case", list(CACHE_CASES))
def test_scales_cache_trust_rules(tiny, first_batch, tmp_path, monkeypatch,
                                  capsys, case):
    """As the JAX engine: a cache is trusted only for the same weights hash,
    pixel pipeline (fast_decode, crop, n_crops) and settings (stat,
    headroom), QAT/distillation scales on the hash alone; anything else
    recalibrates on the first batch (8 distinct images: persisted)."""
    change, trusted = CACHE_CASES[case]
    path = tmp_path / CACHE
    obj = _valid_cache(first_batch)
    if change is None:
        obj = dict(obj["scales"])      # the legacy flat {site: scale} format
    else:
        obj["provenance"].update(change)
    path.write_text(json.dumps(obj))
    if trusted:
        _no_calibration(monkeypatch, pq)
    else:
        _calibrated_once(monkeypatch, tiny, first_batch)
    eng = _engine(tiny, path, calib_stat="absmax")
    preds = eng.predict_batch(tiny[3])
    assert sorted(preds) == eng.pred_keys
    out = capsys.readouterr().out
    assert eng.int8_calib_source == ("cache" if trusted else "first_batch")
    assert ("ignoring scales cache" in out) == (not trusted)
    written = json.loads(path.read_text())
    if trusted:
        assert written == obj and eng.int8_scales == obj["scales"]
    else:
        assert written["provenance"]["source"] == "first_batch"
        assert written["provenance"]["weights_hash"] == eng._qhash


def test_few_distinct_images_are_not_persisted(tiny, tmp_path):
    """A first batch of fewer than 6 distinct images (a padded serving
    micro-batch; a host-cropped image counts once) is not cached."""
    path = tmp_path / CACHE
    images = np.repeat(tiny[3][:2], 4, axis=0)
    eng = _engine(tiny, path, calib_stat="absmax")
    eng.predict_batch(images)
    assert eng.int8_calib_source == "first_batch" and not path.exists()
    crops = np.stack([np.stack([im[:CROP, :CROP]] * 10) for im in tiny[3]])
    eng = _engine(tiny, path, calib_stat="absmax", tta_mode="host_exact")
    eng.predict_batch(crops[:5])
    assert not path.exists()


def test_first_batch_keeps_calib_dir_cache_unlike_jax(tiny, first_batch,
                                                      tmp_path, capsys):
    """The one deliberate divergence from the JAX engine (ADVICE.md's cache
    downgrade, JAX `eval/engine.py:390`): a cache made from a calib_dir and
    rejected for a run's settings is not replaced by that run's first-batch
    calibration -- the JAX engine replaces it -- unless int8_recalibrate;
    one log line says so."""
    path = tmp_path / CACHE
    obj = _valid_cache(first_batch, source="calib_dir",
                       calib_fingerprint="f00")
    path.write_text(json.dumps(obj))
    eng = _engine(tiny, path, calib_stat="p999")     # other settings
    eng.predict_batch(tiny[3])
    out = capsys.readouterr().out
    assert eng.int8_calib_source == "first_batch"
    assert "not replacing the calib_dir scales cache" in out
    assert json.loads(path.read_text()) == obj
    eng = _engine(tiny, path, calib_stat="p999", int8_recalibrate=True)
    eng.predict_batch(tiny[3])
    prov = json.loads(path.read_text())["provenance"]
    assert (prov["source"], prov["stat"]) == ("first_batch", "p999")


def test_auto_records_pick_and_is_trusted_by_auto(tiny, tmp_path,
                                                  monkeypatch):
    """calib_stat 'auto' (the default) records 'auto:<picked>' with the
    per-candidate KLs, ships the picked statistic's scales, and a later
    'auto' run trusts that cache."""
    path = tmp_path / CACHE
    eng = _engine(tiny, path)
    eng.predict_batch(tiny[3])
    picked = eng.int8_calib_stat.split(":", 1)[1]
    assert eng.int8_calib_stat.startswith("auto:")
    assert picked in pq.AUTO_CANDIDATE_STATS
    assert set(eng.int8_calib_kls) == set(pq.AUTO_CANDIDATE_STATS)
    samples = pq.calibrate_samples(tiny[1], [tiny[3]], eng.model_arch,
                                   n_crops=1, crop=CROP, device="cpu")
    assert eng.int8_scales == pq.derive_scales(samples, picked)
    _no_calibration(monkeypatch, pq)
    again = _engine(tiny, path)
    again.predict_batch(tiny[3])
    assert again.int8_calib_source == "cache"
    assert again.int8_calib_stat == eng.int8_calib_stat


def test_default_scales_path_matches_jax(world):
    from geoestimation_tpu.eval.engine import default_scales_path as jax_path

    for ckpt in (world["port"], os.path.join(world["port"], "hparams.yaml")):
        assert default_scales_path(ckpt) == jax_path(ckpt) == os.path.join(
            world["port"], CACHE)


def test_int8_crop_logits_on_host_crops(tiny, tmp_path):
    """5-D host crops through the int8 engine: its per-crop logits are the
    int8 network's on those crops, shifted to (pixel - 128)."""
    eng = _engine(tiny, tmp_path / CACHE, calib_stat="absmax",
                  tta_mode="host_exact")
    crops = np.stack([np.stack([im[i % 8:i % 8 + CROP, i % 8:i % 8 + CROP]
                                for i in range(10)]) for im in tiny[3][:2]])
    logits = eng.crop_logits(torch.from_numpy(crops))
    apply = pq.build_int8_apply(eng._qnet, eng.int8_scales,
                                n_classes=eng._n_classes, device="cpu")
    x = torch.from_numpy(crops.reshape(-1, CROP, CROP, 3).astype(np.int16)
                         - 128).to(torch.int8)
    for g, r in zip(logits, apply(x)):
        assert g.shape == (20, r.shape[-1])
        torch.testing.assert_close(g, r, rtol=0, atol=0)


# -- the server -----------------------------------------------------------------

def test_server_int8_synthetic_warmup_is_not_cached(world, clean_caches,
                                                    monkeypatch, capsys):
    """`serve --precision 8 --warmup` without --calib_dir calibrates on
    noise, says so, serves, and writes no cache."""
    from tests.test_torch_port_serve import jpeg_bytes, post

    from geoestimation_tpu_torch.serve import GeoInferenceServer
    from geoestimation_tpu_torch.serve import server as port_server

    answers = []

    def serve_once(self):
        self.start_background()
        answers.append(post(self, jpeg_bytes(5))["predictions"])
        self.close()

    monkeypatch.setattr(GeoInferenceServer, "serve_forever", serve_once)
    port_server.main(["--checkpoint", world["port"], "--cpu", "--host",
                      "127.0.0.1", "--port", "0", "--batch_size", "2",
                      "--precision", "8", "--warmup"])
    out = capsys.readouterr().out
    assert "WARNING: int8 warmup on synthetic noise" in out
    assert "source=first_batch" in out and "serving on 127.0.0.1:" in out
    assert set(answers[0]) == {"coarse", "middle", "fine", "hierarchy"}
    assert not os.path.exists(clean_caches[1])

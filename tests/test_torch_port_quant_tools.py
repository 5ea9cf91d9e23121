"""The port's QAT, distillation and study tools end to end on tiny worlds
(`tools/qat_finetune.py`, `tools/tta_distill.py`, `tools/quant_study.py`,
`tools/reproduce_tables.py`), on the CPU: a port `train_base` checkpoint
fine-tuned through the quantizer and served at `--precision 8` on the
scales QAT wrote; snapshot retention exporting the original weights at lr
0; a distillation export with its `distill` scales; the study's JSON against
the JAX tool's on one checkpoint in both packages' forms; the tables'
rendering and the int8 gate's exit code."""

import json
import os
import pathlib

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from geoestimation_tpu_torch.checkpoint import load_checkpoint
from geoestimation_tpu_torch.models import qat as pqat
from geoestimation_tpu_torch.tools import world
from geoestimation_tpu_torch.utils.config import load_config
from tests.torch_port_world import PARIS, clustered_world
from tests.torch_port_world import one_thread_no_tensorboard  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
ARCH = "resnet14"


def _images(path, n, seed, size=(80, 80)):
    path.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, size + (3,), dtype=np.uint8)
                        ).save(path / f"x_{i}.jpg", quality=90)
    return str(path)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A seeded shard world on baseM at resnet14 (batch 8, 64-px crops,
    train_crop_scale (0.5, 1.0)) trained 2 steps by the port's train_base,
    and 4 unlabeled images."""
    from geoestimation_tpu_torch.classification import train_base

    root = tmp_path_factory.mktemp("qat_world")
    parts = world.seeded_partitionings(np.random.default_rng(1), (12, 24, 48))
    config = load_config(str(REPO / "configs" / "baseM.yml"))
    config.model_params.arch = ARCH
    tp = config.train_params
    tp.batch_size, tp.image_size, tp.num_workers = 8, 64, 2
    tp.checkpoint_every_steps, tp.keep_checkpoints = 0, 1
    tp.train_crop_scale = [0.5, 1.0]
    path = world.write_shard_world(str(root), parts, config, per_shard=16,
                                   n_val=8, sizes=(72, 96))
    train_base.main(["--config", path, "--max_steps", "2", "--cpu"])
    return {"ckpt": str(root / "ckpt"), "root": root,
            "images": _images(root / "images", 4, 3)}


def _scales_doc(ckpt):
    with open(os.path.join(ckpt, "int8_scales.json")) as f:
        return json.load(f)


def test_qat_finetune_exports_and_serves_at_int8(trained, tmp_path, capsys):
    """train_base -> qat_finetune 2 steps -> classification.inference
    --precision 8, which keeps the scales QAT wrote (source "qat")."""
    from geoestimation_tpu_torch.classification import inference
    from geoestimation_tpu_torch.eval.engine import InferenceEngine
    from geoestimation_tpu_torch.tools import qat_finetune

    out = str(tmp_path / "ckpt_qat")
    assert qat_finetune.main([
        "--checkpoint", trained["ckpt"], "--out", out, "--steps", "2",
        "--lr", "1e-4", "--calib_images", "8", "--batch_size", "4",
        "--eval_images", "8", "--eval_every", "1", "--anchor_weight", "0.5",
        "--cpu"]) == 0
    log = capsys.readouterr().out
    assert "train_crop_scale=(0.5, 1.0)" in log and "anchored QAT" in log
    assert "step    -1  proxy_kl" in log and "snapshot retention:" in log
    doc = _scales_doc(out)
    assert doc["provenance"]["source"] == "qat"
    assert doc["provenance"]["n_images"] == 8

    csv = str(tmp_path / "preds.csv")
    inference.main(["--checkpoint", out, "--image_dir", trained["images"],
                    "--output", csv, "--crops", "1", "--batch_size", "2",
                    "--precision", "8", "--cpu"])
    assert "ignoring scales cache" not in capsys.readouterr().out
    assert len(pd.read_csv(csv)) == 4 * 4
    assert _scales_doc(out) == doc
    config, sd = load_checkpoint(out)
    engine = InferenceEngine(config, sd, n_crops=1, int8=True,
                             int8_scales_path=os.path.join(
                                 out, "int8_scales.json"),
                             search_dirs=[out], device="cpu")
    engine.predict_batch(np.zeros((1, 256, 256, 3), np.uint8))
    assert engine.int8_calib_source == "cache"
    assert engine.int8_scales == doc["scales"]

    # quant_study --pinned_scales measures the export on those scales, and
    # refuses them, as serving would, under another weights hash
    from geoestimation_tpu_torch.tools import quant_study

    meta = str(tmp_path / "meta.csv")
    pd.DataFrame([(f"x_{i}.jpg", 48.0 + i, 2.0) for i in range(4)],
                 columns=["IMG_ID", "LAT", "LON"]).to_csv(meta, index=False)
    study = ["--checkpoint", out, "--image_dir", trained["images"],
             "--meta", meta, "--crops", "1", "--batch_size", "4",
             "--pinned_scales", "--json", str(tmp_path / "pinned.json"),
             "--cpu"]
    assert quant_study.main(study) == 0
    results = json.load(open(tmp_path / "pinned.json"))
    assert list(results["configs"]) == ["pinned:qat/absmax@1"]
    assert results["n_images"] == 4 and results["n_calib"] == 8
    doc["provenance"]["weights_hash"] = "deadbeefdeadbeef"
    with open(os.path.join(out, "int8_scales.json"), "w") as f:
        json.dump(doc, f)
    with pytest.raises(SystemExit, match="rejected"):
        quant_study.main(study)


def test_qat_finetune_at_lr_0_exports_the_original(trained, tmp_path,
                                                   capsys):
    """Snapshot retention: no step at lr 0 beats the PTQ floor, so the
    export is the original network (fold-equal, rtol 2e-5)."""
    from geoestimation_tpu_torch.tools import qat_finetune

    out = str(tmp_path / "ckpt_qat_lr0")
    assert qat_finetune.main([
        "--checkpoint", trained["ckpt"], "--out", out, "--steps", "2",
        "--lr", "0", "--calib_images", "8", "--batch_size", "4",
        "--eval_images", "4", "--eval_every", "1", "--eval_dir",
        trained["images"], "--cpu"]) == 0
    assert "NO QAT step improved" in capsys.readouterr().out
    _, sd0 = load_checkpoint(trained["ckpt"])
    _, sd1 = load_checkpoint(out)
    f0 = dict(pqat.folded_leaves(pqat.fold_variables(sd0, ARCH)))
    for path, t in pqat.folded_leaves(pqat.fold_variables(sd1, ARCH)):
        np.testing.assert_allclose(t.numpy(), f0[path].numpy(), rtol=2e-5,
                                   atol=1e-5, err_msg=path)


def test_tta_distill_exports_with_distill_scales(trained, tmp_path, capsys):
    from geoestimation_tpu_torch.tools import tta_distill

    out = str(tmp_path / "ckpt_ftta")
    assert tta_distill.main([
        "--checkpoint", trained["ckpt"], "--image_dir", trained["images"],
        "--out", out, "--steps", "2", "--batch_size", "2", "--images", "2",
        "--crops", "5", "--level", "3", "--lr", "1e-4", "--log_every", "1",
        "--calib_images", "2", "--cpu"]) == 0
    log = capsys.readouterr().out
    start = next(l for l in log.splitlines() if l.startswith("start"))
    assert float(start.split("exact-kl")[1]) <= 1e-5
    assert "exporting best snapshot" in log
    doc = _scales_doc(out)
    assert doc["provenance"]["source"] == "distill"
    assert doc["provenance"]["n_images"] == 2
    _, sd = load_checkpoint(out)
    assert torch.equal(sd["backbone.bn1.weight"],
                       torch.ones_like(sd["backbone.bn1.weight"]))


# -- the study and the tables against the JAX tools --------------------------

@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """One seeded resnet14 checkpoint as a JAX orbax directory and as a port
    directory, 6 images and their meta CSV."""
    w = clustered_world(tmp_path_factory, seed=11, centers=(PARIS,),
                        n_per_center=3000, img_maxes=(3000, 800, 300),
                        step_in_state=True)
    root = tmp_path_factory.mktemp("study_images")
    images = _images(root / "images", 6, 5, size=(260, 300))
    meta = [(f"x_{i}.jpg", 48.85 + 0.2 * i, 2.35 - 0.1 * i) for i in range(6)]
    pd.DataFrame(meta, columns=["IMG_ID", "LAT", "LON"]).to_csv(
        root / "meta.csv", index=False)
    return {"jax": w["jax"], "port": w["port"], "images": images,
            "meta": str(root / "meta.csv")}


def _same_keys(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same_keys(a[k], b[k], f"{path}/{k}")


@pytest.mark.slow     # both packages' study and a JAX int8 graph: ~25 s
def test_quant_study_json_matches_jax_tool(both, tmp_path, monkeypatch,
                                           capsys):
    """The same settings through both packages' tools: the same JSON keys
    and settings, the same corpus and reference tables, each flip count
    within one image."""
    from tools.quant_study import main as jax_main

    from geoestimation_tpu_torch.tools.quant_study import main

    for pkg in ("geoestimation_tpu", "geoestimation_tpu_torch"):
        monkeypatch.setattr(f"{pkg}.ingest.native.available", lambda: False)
    common = ["--image_dir", both["images"], "--meta", both["meta"],
              "--crops", "1", "--batch_size", "6", "--calib_images", "6",
              "--stats", "absmax,p999", "--cpu"]
    out = {}
    for name, run in (("jax", jax_main), ("port", main)):
        out[name] = str(tmp_path / f"{name}.json")
        assert run(["--checkpoint", both[name], "--json", out[name]]
                   + common) == 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith(("absmax@1", "p999@1", "config"))]
    assert len(lines) == 6 and lines[0] == lines[3]
    ref, got = (json.load(open(out[k])) for k in ("jax", "port"))
    _same_keys(got, ref)
    for key in ("n_images", "n_calib", "crops", "budget_pt", "fast_decode",
                "requant_mode", "corpus"):
        assert got[key] == ref[key], key
    n = ref["n_images"]
    for k, table in ref["ref_tables"].items():
        for t, v in table.items():
            assert abs(got["ref_tables"][k][t] - v) * n <= 1 + 1e-9, (k, t)
    for cfg, r in ref["configs"].items():
        g = got["configs"][cfg]
        assert (g["stat"], g["headroom"], g["tta"]) == (
            r["stat"], r["headroom"], r["tta"])
        for k, rate in r["flip_rates"].items():
            assert abs(g["flip_rates"][k] - rate) * n <= 1 + 1e-9, (cfg, k)


def test_reproduce_tables_render_matches_jax():
    from tools.reproduce_tables import render as jax_render

    from geoestimation_tpu_torch.tools import reproduce_tables as rt

    ours = {k: dict(zip((1.0, 25.0, 200.0, 750.0, 2500.0),
                        np.random.default_rng(i).uniform(0, 1, 5)))
            for i, k in enumerate(("coarse", "middle", "fine", "hierarchy"))}
    for dataset in ("im2gps", "im2gps3k"):
        assert rt.render(dataset, ours) == jax_render(dataset, ours)
    del ours["middle"]
    assert rt.render("im2gps", ours) == jax_render("im2gps", ours)
    with pytest.raises(SystemExit, match="int8 acceptance gate"):
        rt.main(["--checkpoint", "unused", "--max_delta", "1"])


@pytest.mark.slow     # four test-CLI runs at 224 px, int8 on the CPU: ~15 s
def test_reproduce_tables_int8_gate_exit_code(both, capsys):
    from geoestimation_tpu_torch.tools import reproduce_tables as rt

    common = ["--checkpoint", both["port"], "--im2gps_dir", both["images"],
              "--im2gps_meta", both["meta"], "--precision", "8",
              "--crops", "1", "--calib_dir", both["images"],
              "--batch_size", "6", "--cpu"]
    assert rt.main(common + ["--max_delta", "100"]) == 0
    assert "int8 serving gate [im2gps]" in capsys.readouterr().out
    assert rt.main(common + ["--max_delta", "-1"]) == 1

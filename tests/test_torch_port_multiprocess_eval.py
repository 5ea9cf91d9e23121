"""The port's CLIs in two processes on the CPU (gloo), against one process
and the JAX package: `classification.test`'s merged GCD table, the part
files of `classification.inference`, a rank with an empty slice, int8 ranks
deriving the same scales, the engine's `layout` over two CPU devices, and
`train_base` with the lockstep and the strided feed.

Each rank is a subprocess running the CLI's `main` with one torch thread,
a 30 s collective timeout, the TensorBoard import failed (it would import
TensorFlow), in a world of its ranks (`launch.Ranks`: their rendezvous
store, and a time limit from its start); a failing rank fails its peer at
the next collective (gloo), and the limit kills the rest.
"""

import json
import os
import pathlib
import sys

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from geoestimation_tpu.train.checkpoint import save_single
from geoestimation_tpu.utils.config import Config as JaxConfig
from geoestimation_tpu_torch.checkpoint import (
    CheckpointManager,
    load_checkpoint,
    save_checkpoint,
)
from geoestimation_tpu_torch.convert import from_jax_variables
from geoestimation_tpu_torch.eval.engine import InferenceEngine
from geoestimation_tpu_torch.parallel.launch import Ranks
from geoestimation_tpu_torch.parallel.mesh import make_mesh
from geoestimation_tpu_torch.tools import world
from geoestimation_tpu_torch.utils.config import load_config
from tests.torch_port_world import one_thread_no_tensorboard  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
ARCH = "resnet14"
N_IMAGES = 10
LIMIT_S = 90           # a world of ranks, from its start
RUN = ("import sys; sys.modules['torch.utils.tensorboard'] = None; "
       "from geoestimation_tpu_torch.parallel import multihost; "
       "multihost.DEFAULT_TIMEOUT_S = 30; "
       "import importlib; importlib.import_module(sys.argv[1]).main("
       "sys.argv[2:])")


def launch(cli, args, n=2):
    """`n` ranks of geoestimation_tpu_torch.classification.`cli` on the
    CPU, a world of their own (`Ranks`) that ends `LIMIT_S` s after
    its start; `args` a list, or a function of the rank."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return Ranks(n, LIMIT_S).popen(lambda p: [
        sys.executable, "-c", RUN,
        f"geoestimation_tpu_torch.classification.{cli}",
        *(args(p) if callable(args) else args), "--cpu"],
        env=env, cwd=str(REPO))


def finish(ranks, ok=True):
    """Each rank's output; each must exit 0 (or, with ok=False,
    non-zero)."""
    try:
        results = ranks.wait()
    except TimeoutError as e:
        raise AssertionError(str(e)) from None
    for code, out in results:
        assert (code == 0) == ok, out[-4000:]
    return [out for _, out in results]


# -- evaluation ---------------------------------------------------------------

@pytest.fixture(scope="module")
def eval_world(tmp_path_factory):
    """Seeded resnet14 weights as a JAX orbax checkpoint and the port's, 10
    images at the centers of fine cells with their meta CSV, and a folder of
    one of them."""
    root = tmp_path_factory.mktemp("mp_eval")
    rng = np.random.default_rng(23)
    parts = world.seeded_partitionings(rng, (10, 20, 40))
    files = []
    for p in parts:
        files.append(str(root / f"{p.name}.csv"))
        p.to_csv(files[-1])
    config = JaxConfig()
    config.model_params.arch = ARCH
    config.model_params.partitionings.files = files
    counts = [len(p) for p in parts]
    params, stats = world.seeded_jax_variables(rng, ARCH, counts)
    save_single(str(root / "jax"), {"params": params, "batch_stats": stats},
                config=config, step=0, metrics={"val_loss": 1.0})
    port_config = load_config(str(root / "jax" / "hparams.yaml"))
    sd = from_jax_variables(params, stats, ARCH, counts)
    for name in ("port", "port_a", "port_b"):
        save_checkpoint(str(root / name), sd, port_config)
    fine = parts[-1]
    meta = []
    for d in ("images", "one"):
        (root / d).mkdir()
    for i in range(N_IMAGES):
        img = Image.fromarray(rng.integers(0, 255, (280 + 8 * i, 260, 3),
                                           dtype=np.uint8))
        img.save(root / "images" / f"img_{i:03d}.jpg", quality=90)
        if i == 0:
            img.save(root / "one" / "img_000.jpg", quality=90)
        c = int(rng.integers(len(fine)))
        meta.append((f"img_{i:03d}.jpg", float(fine.lat[c]),
                     float(fine.lng[c])))
    pd.DataFrame(meta, columns=["IMG_ID", "LAT", "LON"]).to_csv(
        root / "meta.csv", index=False)
    return {k: str(root / k) for k in
            ("jax", "port", "port_a", "port_b", "images", "one")} | {
        "meta": str(root / "meta.csv"), "root": root, "config": port_config,
        "sd": sd, "parts": parts}


def _test_args(w, ckpt, images, json_out, *extra):
    return ["--checkpoint", w[ckpt], "--image_dirs", w[images],
            "--meta_files", w["meta"], "--batch_size", "4", "--crops", "1",
            "--json", json_out, *extra]


@pytest.fixture(scope="module")
def eval_runs(eval_world, tmp_path_factory):
    """Every two-process eval run, started together: the test CLI on the
    folder and on the one-image folder (rank 1 idle), in int8 (each rank on
    its own copy of the checkpoint, so each writes its own scales cache),
    and the inference CLI's part files; then their single-process
    counterparts here."""
    from geoestimation_tpu_torch.classification import inference
    from geoestimation_tpu_torch.classification import test as port_test

    w, out = eval_world, tmp_path_factory.mktemp("mp_eval_out")
    int8 = ["--precision", "8", "--calib_images", "4", "--calib_stat",
            "absmax"]
    runs = {
        "table": launch("test", _test_args(w, "port", "images",
                                           str(out / "table.json"))),
        "idle": launch("test", _test_args(w, "port", "one",
                                          str(out / "idle.json"))),
        "parts": launch("inference", [
            "--checkpoint", w["port"], "--image_dir", w["images"],
            "--batch_size", "4", "--crops", "1", "--output",
            str(out / "multi.csv")]),
    }
    runs["int8"] = launch("test", lambda p: _test_args(
        w, ("port_a", "port_b")[p], "images", str(out / f"int8_{p}.json"),
        *int8))
    port_test.main(_test_args(w, "port", "images", str(out / "s_table.json"),
                              "--cpu"))
    port_test.main(_test_args(w, "port", "one", str(out / "s_idle.json"),
                              "--cpu"))
    port_test.main(_test_args(w, "port", "images", str(out / "s_int8.json"),
                              *int8, "--calib_dir", w["images"], "--cpu"))
    inference.main(["--checkpoint", w["port"], "--image_dir", w["images"],
                    "--batch_size", "4", "--crops", "1", "--output",
                    str(out / "single.csv"), "--cpu"])
    logs = {k: finish(procs) for k, procs in runs.items()}
    return {"out": out, "logs": logs}


def _load(path):
    with open(path) as f:
        return json.load(f)


def test_two_process_table_equals_single_and_jax(eval_world, eval_runs,
                                                 tmp_path):
    """The merged table (rank 0's --json) equals one process's and the JAX
    CLI's on the same images; rank 1 writes no --json and prints no
    table."""
    from classification.test import main as jax_test

    w, out = eval_world, eval_runs["out"]
    merged = _load(out / "table.json")
    assert merged == _load(out / "s_table.json")
    jax_test(_test_args(w, "jax", "images", str(tmp_path / "jax.json"),
                        "--cpu"))
    assert merged == _load(tmp_path / "jax.json")
    name = os.path.basename(w["images"])
    assert set(merged[name]) == {"coarse", "middle", "fine", "hierarchy"}
    assert merged[name]["hierarchy"]["2500.0"] > 0
    rank0, rank1 = eval_runs["logs"]["table"]
    assert "p_key" in rank0 and "p_key" not in rank1
    assert "device group gloo (on the CPU)" in rank0


def test_idle_rank_still_merges(eval_runs):
    """One image over two ranks: rank 1's slice is empty, it still joins
    the merge, and the table is one process's."""
    out = eval_runs["out"]
    assert _load(out / "idle.json") == _load(out / "s_idle.json")


def test_inference_parts_concatenate_to_single(eval_runs):
    out = eval_runs["out"]
    parts = [pd.read_csv(out / f"multi.csv.part-{p}-of-2") for p in range(2)]
    assert not set(parts[0].img_id) & set(parts[1].img_id)
    got = pd.concat(parts).sort_values(["img_id", "p_key"]).reset_index(
        drop=True)
    want = pd.read_csv(out / "single.csv").sort_values(
        ["img_id", "p_key"]).reset_index(drop=True)
    pd.testing.assert_frame_equal(got, want)
    assert got.img_id.nunique() == N_IMAGES


def test_inference_in_two_processes_needs_output(eval_world):
    outs = finish(launch("inference", [
        "--checkpoint", eval_world["port"], "--image_dir",
        eval_world["images"]]), ok=False)
    for out in outs:
        assert "multi-process inference requires --output" in out


def test_int8_ranks_derive_the_same_scales(eval_world, eval_runs):
    """Both int8 ranks default --calib_dir to the image folder (rank 0 says
    so), write identical scales caches from it, and the merged table is
    that of one process calibrated on the same folder."""
    w = eval_world
    caches = [_load(os.path.join(w[c], "int8_scales.json"))
              for c in ("port_a", "port_b")]
    assert caches[0] == caches[1]
    assert caches[0]["provenance"]["source"] == "calib_dir"
    rank0, rank1 = eval_runs["logs"]["int8"]
    said = f"defaulting --calib_dir to {w['images']}"
    assert said in rank0 and said not in rank1
    out = eval_runs["out"]
    assert _load(out / "int8_0.json") == _load(out / "s_int8.json")
    assert not (out / "int8_1.json").exists()


def test_engine_layout_over_two_cpu_devices_matches_unsharded(eval_world):
    """JAX's TestShardedEval.test_engine_sharded_matches_unsharded: a
    replica on each of two devices, the batch split between them."""
    w = eval_world
    images = np.random.default_rng(0).integers(0, 255, (4, 256, 256, 3),
                                               dtype=np.uint8)
    kw = dict(partitionings=w["parts"], n_crops=1, device="cpu")
    for extra in ({}, {"fast": True, "use_pallas": True}):
        plain = InferenceEngine(w["config"], w["sd"], **kw, **extra)
        sharded = InferenceEngine(w["config"], w["sd"], **kw, **extra,
                                  layout=make_mesh(devices=["cpu", "cpu"]))
        assert len(sharded.devices) == 2
        pa, pb = plain.predict_batch(images), sharded.predict_batch(images)
        for key in pa:
            np.testing.assert_array_equal(pa[key][0], pb[key][0])
            np.testing.assert_allclose(pa[key][1], pb[key][1], atol=1e-4)
    with pytest.raises(ValueError, match="does not split evenly"):
        sharded.predict_batch(images[:3])


# -- training -----------------------------------------------------------------

def _train_world(root, train_shards, per_shard, feed="lockstep"):
    """`tools.world.write_shard_world` on the baseM recipe at resnet14,
    float32, batch 8, 64-px crops."""
    parts = world.seeded_partitionings(np.random.default_rng(1), (12, 24, 48))
    config = load_config(str(REPO / "configs" / "baseM.yml"))
    config.model_params.arch = ARCH
    config.model_params.dtype = "float32"
    tp = config.train_params
    tp.batch_size, tp.image_size, tp.num_workers = 8, 64, 2
    tp.log_every_steps, tp.checkpoint_every_steps = 1, 0
    tp.keep_checkpoints = 3
    tp.data_feed = feed
    return world.write_shard_world(str(root), parts, config,
                                   train_shards=train_shards,
                                   per_shard=per_shard, n_val=8,
                                   sizes=(72, 96))


def _train_args(config, ckpt, steps):
    return ["--config", config, "--checkpoint_dir", ckpt, "--max_steps",
            str(steps), "--no_resume"]


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """Two processes on the lockstep feed (2 shards of 16), on the strided
    feed over 3 uneven shards of 16 (rank 0 reads two, rank 1 one) for 6
    steps, and on the strided feed with 1 shard, started together; the
    single-process lockstep run here."""
    from geoestimation_tpu_torch.classification import train_base

    root = tmp_path_factory.mktemp("mp_train")
    lock = _train_world(root / "lock", 2, 16)
    strided = _train_world(root / "strided", 3, 16, "strided")
    few = _train_world(root / "few", 1, 16, "strided")
    runs = {
        "lock": launch("train_base", _train_args(lock, str(root / "multi"),
                                                 4)),
        "strided": launch("train_base", _train_args(
            strided, str(root / "strided_ckpt"), 6)),
        "few": launch("train_base", _train_args(few, str(root / "few_ckpt"),
                                                4)),
    }
    train_base.main(_train_args(lock, str(root / "single"), 4) + ["--cpu"])
    logs = {k: finish(procs, ok=k != "few") for k, procs in runs.items()}
    return {"root": root, "logs": logs}


def test_lockstep_pair_equals_one_process(train_runs):
    """The two-process run's final checkpoint holds one process's
    parameters and statistics (float32; gloo sums the gradients and the
    BatchNorm sums in another order than one process's reductions)."""
    root = train_runs["root"]
    _, multi = load_checkpoint(str(root / "multi"))
    _, single = load_checkpoint(str(root / "single"))
    assert multi.keys() == single.keys()
    for k in single:
        torch.testing.assert_close(multi[k], single[k], rtol=1e-4,
                                   atol=1e-5, msg=k)
    rank0, rank1 = train_runs["logs"]["lock"]
    assert "step 4/4" in rank0 and "step " not in rank1


def test_strided_uneven_shards_end_both_ranks_at_one_step(train_runs):
    """Rank 1 runs dry after 4 of rank 0's 8 local batches an epoch; both
    ranks roll over together and stop at step 6."""
    root = train_runs["root"]
    assert CheckpointManager(str(root / "strided_ckpt")).all_steps() == [4, 6]
    rank0, _ = train_runs["logs"]["strided"]
    assert "step 6/6" in rank0 and "epoch end @ 4" in rank0


def test_strided_with_too_few_shards_fails_fast_on_both_ranks(train_runs):
    for out in train_runs["logs"]["few"]:
        assert "data_feed: strided needs >= 1 shard per process" in out

"""What the port's CPU tests share.

`one_thread_no_tensorboard`: a module-scoped autouse fixture; a test file
of the port imports it (`from tests.torch_port_world import
one_thread_no_tensorboard`), and then the file's tests and its fixtures
run torch on one intra-op thread, with TensorBoard's import failed. Several
test workers share this CPU, and torch's thread barriers stall on threads
that wait for a core: a resnet14 step that takes 0.1 s alone took 30 s
under six workers, and the waiting threads spin, so the suite's
core-seconds grew with them. TensorBoard's import would import TensorFlow
here (16 s); the trainer's `MetricsLogger` takes its failure silently, as
the JAX package's does.

`clustered_world`: a seeded resnet14 world in both packages' formats,
built once per process for each set of arguments.
"""

import sys

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread_no_tensorboard():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield
    torch.set_num_threads(threads)


# -- the seeded worlds --------------------------------------------------------

_worlds = {}

PARIS, NEW_YORK = (48.85, 2.35), (40.7, -74.0)


def clustered_world(tmp_path_factory, *, seed, centers, n_per_center,
                    img_maxes, n_images=0, first_height=300, init=False,
                    n_scenes=None, step_in_state=False,
                    missing_meta_row=False):
    """A resnet14 world in both packages' formats, built once per process
    for each set of arguments, from `np.random.default_rng(seed)` in this
    order: `n_per_center` points around each of `centers` (latitudes, then
    longitudes; sd 0.4 degrees), three partitionings of them (`create_cells`,
    img_min 10, `img_maxes` coarse to fine); the weights, seeded
    (`tools.world.seeded_jax_variables`, ISN with `n_scenes`) or, with
    `init`, the JAX package's `init_model_state` (seed 0, 64 px); then
    `n_images` JPEGs (`img_{i:03d}.jpg`, (first_height + 10 i) x 260,
    quality 90) and their meta CSV ((48.85 + 0.01 i, 2.35), and a row
    for an image not in the folder with `missing_meta_row`).

    The JAX orbax checkpoint (step 0, val_loss 1.0; with `step_in_state`
    the state also holds "step": 0) and the port's checkpoint converted
    from it as `load_for_inference` restores it. Returns {"jax", "port",
    "root", "counts", "config" (the restored JAX config), "restored"}, and
    "images" and "meta" with images (a fresh dict; the files are shared).
    """
    key = (seed, tuple(centers), n_per_center, tuple(img_maxes), n_images,
           first_height, init, n_scenes, step_in_state, missing_meta_row)
    if key not in _worlds:
        _worlds[key] = _build_world(tmp_path_factory.mktemp(f"world{seed}"),
                                    *key)
    return dict(_worlds[key])


def _build_world(root, seed, centers, n_per_center, img_maxes, n_images,
                 first_height, init, n_scenes, step_in_state,
                 missing_meta_row):
    import numpy as np
    import pandas as pd
    from PIL import Image

    from geoestimation_tpu.geo import create_cells
    from geoestimation_tpu.geo import load_partitionings as jax_parts
    from geoestimation_tpu.train.checkpoint import (
        load_for_inference,
        save_single,
    )
    from geoestimation_tpu.utils.config import Config
    from geoestimation_tpu_torch.checkpoint import save_checkpoint
    from geoestimation_tpu_torch.convert import from_jax_variables
    from geoestimation_tpu_torch.tools.world import seeded_jax_variables
    from geoestimation_tpu_torch.utils.config import load_config

    rng = np.random.default_rng(seed)
    lat = np.concatenate([c[0] + rng.normal(0, .4, n_per_center)
                          for c in centers])
    lng = np.concatenate([c[1] + rng.normal(0, .4, n_per_center)
                          for c in centers])
    names = ["coarse", "middle", "fine"]
    files, counts = [], []
    for img_max, name in zip(img_maxes, names):
        part = create_cells(lat, lng, img_min=10, img_max=img_max,
                            name=name).partitioning
        files.append(str(root / f"{name}.csv"))
        part.to_csv(files[-1])
        counts.append(len(part))
    config = Config()
    config.model_params.arch = "resnet14"
    config.model_params.partitionings.files = files
    config.model_params.scene_gating = bool(n_scenes)
    if init:
        from geoestimation_tpu.train.init import init_model_state

        _, state = init_model_state(config, jax_parts(files, names=names),
                                    seed=0, image_size=64)
    else:
        params, stats = seeded_jax_variables(rng, "resnet14", counts,
                                             n_scenes)
        state = {"params": params, "batch_stats": stats}
        if step_in_state:
            state["step"] = 0
    jax_ckpt = str(root / "jax_ckpt")
    save_single(jax_ckpt, state, config=config, step=0,
                metrics={"val_loss": 1.0})
    cfg, restored = load_for_inference(jax_ckpt)
    port_ckpt = str(root / "port_ckpt")
    save_checkpoint(port_ckpt, from_jax_variables(
        restored["params"], restored["batch_stats"], cfg.model_params.arch,
        counts), load_config(str(root / "jax_ckpt" / "hparams.yaml")))
    world = {"jax": jax_ckpt, "port": port_ckpt, "root": root,
             "counts": counts, "config": cfg, "restored": restored}
    if not n_images:
        return world
    img_dir = root / "images"
    img_dir.mkdir()
    meta = []
    for i in range(n_images):
        arr = rng.integers(0, 255, (first_height + 10 * i, 260, 3),
                           dtype=np.uint8)
        Image.fromarray(arr).save(img_dir / f"img_{i:03d}.jpg", quality=90)
        meta.append((f"img_{i:03d}.jpg", 48.85 + 0.01 * i, 2.35))
    if missing_meta_row:
        meta.append(("not_in_dir.jpg", 0.0, 0.0))
    pd.DataFrame(meta, columns=["IMG_ID", "LAT", "LON"]).to_csv(
        root / "meta.csv", index=False)
    return {**world, "images": str(img_dir), "meta": str(root / "meta.csv")}

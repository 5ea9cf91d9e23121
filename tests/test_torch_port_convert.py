"""`convert_orbax.py`: a JAX (orbax) checkpoint converted for the port gives
the JAX inference CLI's CSV through the port's CLI, for a base and an ISN
checkpoint; the best step is taken unless --step says otherwise, and the
int8 scales cache comes along."""

import os

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import convert_orbax
from geoestimation_tpu.train.checkpoint import save_single
from geoestimation_tpu.utils.config import Config as JaxConfig
from geoestimation_tpu_torch.convert import from_jax_variables
from geoestimation_tpu_torch.tools import world

ARCH = "resnet14"


@pytest.fixture
def pil_both(monkeypatch):
    """Both packages decode through PIL, so both see the same pixels."""
    monkeypatch.setattr("geoestimation_tpu.ingest.native.available",
                        lambda: False)
    monkeypatch.setattr("geoestimation_tpu_torch.ingest.native.available",
                        lambda: False)


@pytest.fixture(scope="module", params=["base", "isn"])
def orbax_world(request, tmp_path_factory):
    """An orbax checkpoint of seeded weights at two steps (step 1 the best
    by val_loss, step 2 the latest), with an int8 scales cache, and a
    folder of JPEGs."""
    n_scenes = 3 if request.param == "isn" else None
    root = tmp_path_factory.mktemp(f"orbax_{request.param}")
    rng = np.random.default_rng(17)
    parts = world.seeded_partitionings(rng, (10, 20, 40))
    config = JaxConfig()
    config.model_params.arch = ARCH
    config.model_params.partitionings.files = []
    for p in parts:
        config.model_params.partitionings.files.append(
            str(root / f"{p.name}.csv"))
        p.to_csv(config.model_params.partitionings.files[-1])
    config.model_params.scene_gating = bool(n_scenes)
    counts = [len(p) for p in parts]
    ckpt = str(root / "jax_ckpt")
    variables = []
    for step, val_loss in ((1, 1.0), (2, 2.0)):
        params, stats = world.seeded_jax_variables(rng, ARCH, counts,
                                                   n_scenes)
        save_single(ckpt, {"params": params, "batch_stats": stats},
                    config=config, step=step, metrics={"val_loss": val_loss})
        variables.append(from_jax_variables(params, stats, ARCH, counts))
    with open(os.path.join(ckpt, "int8_scales.json"), "w") as f:
        f.write('{"version": 2, "scales": {}}\n')
    images = root / "images"
    images.mkdir()
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (280 + 10 * i, 260, 3),
                                     dtype=np.uint8)).save(
            images / f"img_{i}.jpg", quality=90)
    return {"jax": ckpt, "root": root, "images": str(images),
            "variables": variables}


def _same_weights(port_dir, want):
    got = torch.load(os.path.join(port_dir, "state_dict.pt"),
                     weights_only=True)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_converted_checkpoint_gives_the_jax_cli_csv(orbax_world, tmp_path,
                                                    pil_both):
    from classification.inference import main as jax_main

    from geoestimation_tpu_torch.classification.inference import main

    port = str(tmp_path / "port")
    convert_orbax.main(["--checkpoint", orbax_world["jax"], "--output", port])
    _same_weights(port, orbax_world["variables"][0])
    with open(os.path.join(orbax_world["jax"], "int8_scales.json")) as a, \
            open(os.path.join(port, "int8_scales.json")) as b:
        assert a.read() == b.read()
    common = ["--image_dir", orbax_world["images"], "--batch_size", "4",
              "--crops", "10", "--precision", "32", "--cpu"]
    jax_main(["--checkpoint", orbax_world["jax"], "--output",
              str(tmp_path / "jax.csv")] + common)
    main(["--checkpoint", port, "--output", str(tmp_path / "port.csv")]
         + common)
    ref = pd.read_csv(tmp_path / "jax.csv")
    got = pd.read_csv(tmp_path / "port.csv")
    assert list(got.columns) == list(ref.columns)
    assert len(got) == len(ref) == 4 * 4
    assert (got.img_id == ref.img_id).all() and (got.p_key == ref.p_key).all()
    np.testing.assert_array_equal(got.pred_class, ref.pred_class)
    np.testing.assert_allclose(got.pred_lat, ref.pred_lat, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.pred_lng, ref.pred_lng, rtol=0, atol=1e-5)


def test_step_flag_picks_the_step(orbax_world, tmp_path):
    port = str(tmp_path / "port")
    convert_orbax.main(["--checkpoint", orbax_world["jax"], "--output", port,
                        "--step", "2"])
    _same_weights(port, orbax_world["variables"][1])

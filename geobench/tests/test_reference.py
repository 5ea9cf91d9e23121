"""The plain reference agrees with the port on the CPU at a small size: the
float32 forward, the ancestor maps, the f* answers and the host decode."""

import numpy as np
import pytest
import torch

from geobench import harness
from geobench.frozen.world import textured_image
from geobench.reference import decode, geo, model
from geobench.tests import tiny


def test_forward_matches_the_module_path():
    cfg = dict(tiny.CONFIG, arch="resnet50", stage_sizes=[3, 4, 6, 3])
    cpu = torch.device("cpu")
    sd = harness.make_state_dict(cfg, 5, cpu)
    parts = harness.make_partitionings(cfg, 5)
    photos = harness.make_photos(2, cfg["base"], 5, cpu)
    cell = {"config": cfg, "engine": {"dtype": torch.float32}}
    engine = harness.build_engine(cell, sd, parts, cpu)
    theirs = torch.cat(engine.crop_logits(torch.as_tensor(photos)), dim=-1)
    ours = model.crop_logits(torch.as_tensor(photos), sd, cfg["arch"],
                             crop=cfg["crop"])
    assert ours.shape == theirs.shape == (20, sum(cfg["class_counts"]))
    torch.testing.assert_close(ours, theirs, rtol=1e-4, atol=1e-4)


def test_ancestor_maps_and_answers():
    from geoestimation_tpu_torch.eval.infer import (
        HierarchyArrays,
        mean_tta_logits,
        predict_all,
    )
    from geoestimation_tpu_torch.geo import Hierarchy

    cfg = {"class_counts": [3298, 7202, 12893]}
    parts = harness.make_partitionings(cfg, 9)
    maps, valid = geo.ancestor_maps(parts)
    hierarchy = Hierarchy.build(harness.port_partitionings(parts))
    assert all((np.asarray(a) == b).all() for a, b in zip(hierarchy.maps, maps))
    assert (hierarchy.valid == valid).all()

    logits = torch.randn(30, sum(cfg["class_counts"]),
                         generator=torch.Generator().manual_seed(1)) * 2
    harrays = HierarchyArrays.from_hierarchy(hierarchy)
    heads = torch.split(logits, cfg["class_counts"], dim=-1)
    answers = predict_all([mean_tta_logits(h, 10) for h in heads], harrays)
    ref = geo.scores(logits, parts, maps, valid)
    for key, (cls, lat, lng) in answers.items():
        assert (cls.numpy() == ref[key].argmax(1).numpy()).all()
    judged = geo.judge({k: tuple(t.numpy() for t in v)
                        for k, v in answers.items()}, ref, parts)
    assert judged["max_gap"] == 0 and judged["coords_off"] == 0


@pytest.mark.parametrize("size", [(640, 480), (427, 640), (640, 640),
                                  (300, 257)])
def test_decode_matches_the_port(size):
    from geoestimation_tpu_torch.ingest.decode import decode_pil

    blob = textured_image(np.random.default_rng(4), 0, 1, *size, 90)
    assert (decode.decode(blob) == decode_pil(blob)).all()


def test_control_rounds():
    from geobench.reference.quant import fp8, int4

    w = torch.randn(8, 16, 3, 3, generator=torch.Generator().manual_seed(2))
    q = int4(w, "weight")
    steps = q / (w.abs().amax(dim=(1, 2, 3), keepdim=True) / 7)
    assert torch.allclose(steps, steps.round(), atol=1e-4)
    assert steps.abs().max() <= 7 + 1e-4
    assert 0 < (fp8(w, "weight") - w).abs().max() < 0.1 * w.abs().max()


def test_train_steps_match_the_port_in_float32():
    """The reference's three training steps (its own decode, labels,
    crops, train-mode forward, loss and SGD) follow the port's train step
    run in float32 on the same world, to float32 round-off."""
    import copy

    c = copy.deepcopy(tiny.TRAIN)
    c["recipe"]["dtype"] = "float32"
    r = tiny.run(c, seconds=0.2).readings
    assert r["loss_gap"] < 1e-5, r
    assert r["grad_gap_worst"] < 1e-3 and r["change_gap_worst"] < 1e-3, r
    assert r["leaves_left_out"] == 0

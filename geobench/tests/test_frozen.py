"""Each frozen copy of the yardstick gives today what the port's own tool
gives, at the cells' shapes: the kernels' cost functions, the card's peaks,
the operation count, the seeded partitionings and the textured JPEGs."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from geobench.frozen import costs, flops, world
from geobench.frozen import s2 as frozen_s2
from geoestimation_tpu_torch.geo import s2 as port_s2
from geoestimation_tpu_torch.tools import bench_kernels, card
from geoestimation_tpu_torch.tools import make_demo_world
from geoestimation_tpu_torch.tools import world as port_world

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
ARCHS = ("resnet50", "resnet101")
N = 640   # a batch of 64 photos, ten crops each


def test_peaks():
    assert costs.H100_BF16_FLOPS == card.H100_BF16_FLOPS
    assert costs.H100_INT8_OPS == card.H100_INT8_OPS
    assert costs.H100_BYTES_PER_S == card.H100_BYTES_PER_S
    ms, by = card.bound_ms(1e12, 1e9)
    assert costs.bound_s(1e12, 1e9, costs.H100_BF16_FLOPS) * 1e3 == ms


@pytest.mark.parametrize("arch", ARCHS)
def test_conv_s8_cost(arch):
    shapes = costs.int8_conv_shapes(N, arch)
    assert shapes == bench_kernels.int8_conv_shapes(N, arch)
    for _, key, _ in shapes:
        assert costs.conv_s8_cost(key) == bench_kernels.conv_s8_cost(key)
    assert costs.conv_s8_forward_bound_s(N, arch)[1] == sum(
        c for _, _, c in shapes)


@pytest.mark.parametrize("arch", ARCHS)
def test_block_cost(arch):
    blocks = costs.fused_stride1_blocks(N, arch)
    assert len(blocks) == 6
    for stride, *case in bench_kernels.CASES.values():
        assert costs.block_cost(*case, stride) == \
            bench_kernels.block_cost(*case, stride)
    for b in blocks:
        assert costs.block_cost(*b) == bench_kernels.block_cost(*b)


@pytest.mark.parametrize("name", ["resnet50_baseM", "resnet101_baseM"])
def test_operation_count(name):
    """The frozen count equals the same `FlopCounterMode` count over the
    port's classifier module at the cell's shapes (meta tensors)."""
    from torch.utils.flop_counter import FlopCounterMode

    from geoestimation_tpu_torch.train.init import model_from_config
    from geoestimation_tpu_torch.utils.config import Config

    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    config = Config()
    config.model_params.arch = cfg["arch"]
    with torch.device("meta"):
        model = model_from_config(config, tuple(cfg["class_counts"]),
                                  torch.float32)
    x = torch.empty((cfg["n_crops"], cfg["crop"], cfg["crop"], 3),
                    device="meta")
    with FlopCounterMode(display=False) as counter:
        model(x)
    assert flops.ops_per_photo(cfg) == counter.get_total_flops()


@pytest.mark.parametrize("name", ["resnet50_baseM"])
def test_train_operation_count(name):
    """The frozen count of a training step equals the count over the port's
    classifier in train mode, forward and backward (meta tensors), as
    `tools/train_roofline.py` counts a step."""
    from torch.utils.flop_counter import FlopCounterMode

    from geoestimation_tpu_torch.train.init import model_from_config
    from geoestimation_tpu_torch.utils.config import Config

    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    config = Config()
    config.model_params.arch = cfg["arch"]
    with torch.device("meta"):
        model = model_from_config(config, tuple(cfg["class_counts"]),
                                  torch.float32)
    x = torch.empty((2, 224, 224, 3), device="meta")
    with FlopCounterMode(display=False) as counter:
        torch.cat(model(x, train=True), dim=-1).sum().backward()
    assert flops.train_ops_per_image(cfg, 224) * 2 == \
        counter.get_total_flops()


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_seeded_partitionings(seed):
    ours = world.seeded_partitionings(np.random.default_rng(seed))
    theirs = port_world.seeded_partitionings(np.random.default_rng(seed))
    for (name, tokens, lat, lng), p in zip(ours, theirs):
        assert name == p.name
        assert (tokens == p.tokens).all()
        assert (lat == p.lat).all() and (lng == p.lng).all()


def test_s2_copy():
    rng = np.random.default_rng(3)
    lat = np.degrees(np.arcsin(rng.uniform(-1, 1, 500)))
    lng = rng.uniform(-180, 180, 500)
    ids = frozen_s2.latlng_to_cell_id(lat, lng)
    assert (ids == port_s2.latlng_to_cell_id(lat, lng)).all()
    for level in (6, 8, 13):
        p = frozen_s2.parent_at_level(ids, level)
        assert (p == port_s2.parent_at_level(ids, level)).all()
        assert (frozen_s2.id_to_token(p) == port_s2.id_to_token(p)).all()
        a, b = frozen_s2.cell_id_to_latlng(p), port_s2.cell_id_to_latlng(p)
        assert (a[0] == b[0]).all() and (a[1] == b[1]).all()


@pytest.mark.parametrize("size", [(640, 480), (427, 640), (640, 640)])
def test_textured_image(size):
    w, h = size
    ours = world.textured_image(np.random.default_rng(11), 2, 3, w, h, 87)
    theirs = make_demo_world.textured_image(np.random.default_rng(11), 2, 3,
                                            w, h, quality=87)
    assert ours == theirs

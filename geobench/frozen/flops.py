"""Useful operations of one photo, counted from the published shapes as
`geoestimation_tpu_torch/tools/train_roofline.py` counts a step's:
`torch.utils.flop_counter.FlopCounterMode` (2 per multiply-add of every
convolution and matrix product), here over the reference's forward of the
photo's crops on the meta device, so nothing is computed."""

from __future__ import annotations

import functools


@functools.lru_cache(maxsize=None)
def _ops_per_photo(arch, stage_sizes, class_counts, feature_dim, crop,
                   n_crops):
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .. import harness
    from ..reference import model

    leaves = harness.state_dict_leaves(arch, class_counts, stage_sizes,
                                       feature_dim)
    sd = {key: torch.empty(shape, device="meta")
          for key, shape, *_ in leaves}
    x = torch.empty((n_crops, 3, crop, crop), device="meta")
    with FlopCounterMode(display=False) as counter:
        model.logits(model.features(x, sd, arch), sd)
    return float(counter.get_total_flops())


def ops_per_photo(config):
    """Operations of one photo's crops through the trunk and the heads."""
    return _ops_per_photo(config["arch"], tuple(config["stage_sizes"]),
                          tuple(config["class_counts"]),
                          config["feature_dim"], config["crop"],
                          config["n_crops"])


@functools.lru_cache(maxsize=None)
def _train_ops_per_image(arch, stage_sizes, class_counts, feature_dim, crop):
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .. import harness
    from ..reference import train

    leaves = harness.state_dict_leaves(arch, class_counts, stage_sizes,
                                       feature_dim)
    params = {key: torch.empty(shape, device="meta", requires_grad=True)
              for key, shape, *_ in leaves
              if key.rsplit(".", 1)[-1] in train.TRAINABLE}
    x = torch.empty((2, 3, crop, crop), device="meta")
    with FlopCounterMode(display=False) as counter:
        train.forward(x, params, arch).sum().backward()
    return float(counter.get_total_flops()) / 2


def train_ops_per_image(config, crop):
    """Operations of one image's training step at `crop`: the forward and
    the backward of its convolutions and of the head (the input's own
    gradient is not computed)."""
    return _train_ops_per_image(config["arch"], tuple(config["stage_sizes"]),
                                tuple(config["class_counts"]),
                                config["feature_dim"], crop)

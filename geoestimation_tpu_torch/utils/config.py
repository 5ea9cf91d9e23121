"""Typed configuration: the hparams.yaml schema of the JAX package.

The same dataclasses and the same key check as
`geoestimation_tpu/utils/config.py`, so one hparams.yaml configures both
packages; unknown keys are rejected. `yaml` is imported only where a file is
read or written.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence


@dataclass
class PartitioningConfig:
    files: Sequence[str] = (
        "resources/s2_cells/cells_50_5000.csv",
        "resources/s2_cells/cells_50_2000.csv",
        "resources/s2_cells/cells_50_1000.csv",
    )
    shortnames: Sequence[str] = ("coarse", "middle", "fine")


@dataclass
class ModelConfig:
    arch: str = "resnet50"
    partitionings: PartitioningConfig = field(default_factory=PartitioningConfig)
    dtype: str = "bfloat16"          # compute dtype for the backbone
    # ISN variant (reference README.md:187): scene-gated heads.
    scene_gating: bool = False
    n_scenes: int = 3
    # training only: recompute each residual block on the backward pass
    remat: bool = False


@dataclass
class OptimizerConfig:
    name: str = "sgd"
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 1e-4
    nesterov: bool = False


@dataclass
class LRScheduleConfig:
    name: str = "multistep"
    milestones: Sequence[int] = (4, 8, 12)   # epochs
    gamma: float = 0.5
    warmup_epochs: float = 0.0


@dataclass
class TrainConfig:
    batch_size: int = 256
    epochs: int = 15
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    lr_schedule: LRScheduleConfig = field(default_factory=LRScheduleConfig)
    train_shards: Sequence[str] = ()          # msgpack shard files/globs
    val_shards: Sequence[str] = ()
    train_labels: Optional[str] = None        # CSV: IMG_ID + class labels
    val_labels: Optional[str] = None
    num_workers: int = 4
    label_smoothing: float = 0.0
    # ISN only: weight of the scene-classification CE in the joint loss
    # (reference README.md:209-210 S3 routing; raise it when the scene
    # signal is subtler than the geo cues, e.g. texture-defined scenes)
    scene_loss_weight: float = 1.0
    checkpoint_dir: str = "models/base_M"
    checkpoint_every_steps: int = 1000
    keep_checkpoints: int = 3
    log_every_steps: int = 50
    val_every_steps: int = 0                  # 0 = once per epoch
    seed: int = 0
    # image pipeline
    image_size: int = 224
    train_crop_scale: Sequence[float] = (0.66, 1.0)
    steps_per_epoch: Optional[int] = None     # None = derive from data
    # parallelism: data-parallel shards; 1 axis is the reference behavior
    mesh_shape: Optional[Sequence[int]] = None   # None = all devices on data
    profile_dir: Optional[str] = None
    # multi-process input feed (parallel/multihost.py): 'lockstep' (every
    # host decodes the full global batch, exact single-host semantics) or
    # 'strided' (each host reads shards[p::n] and decodes only its local
    # rows — IO/decode 1/N, batch composition differs from single-host)
    data_feed: str = "lockstep"


@dataclass
class Config:
    model_params: ModelConfig = field(default_factory=ModelConfig)
    train_params: TrainConfig = field(default_factory=TrainConfig)


def _build(cls, data):
    if data is None:
        return cls()
    kwargs = {}
    hints = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in data.items():
        if key not in hints:
            raise ValueError(
                f"unknown config key {key!r} for {cls.__name__}; "
                f"valid keys: {sorted(hints)}"
            )
        f = hints[key]
        sub = {
            "partitionings": PartitioningConfig,
            "optimizer": OptimizerConfig,
            "lr_schedule": LRScheduleConfig,
            "model_params": ModelConfig,
            "train_params": TrainConfig,
        }.get(key)
        kwargs[key] = _build(sub, value) if sub and isinstance(value, dict) \
            else value
    return cls(**kwargs)


def load_config(path: str) -> Config:
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return _build(Config, raw)


def save_config(config: Config, path: str):
    import yaml

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(config), f, sort_keys=False)

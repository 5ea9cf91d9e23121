"""The port's checkpoint directory: `hparams.yaml` + `state_dict.pt`.

`hparams.yaml` has the JAX package's schema (`utils/config.py`);
`state_dict.pt` holds the classifier's state dict (float32 tensors under
torchvision's keys, see `convert.py`).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .utils.config import Config, load_config, save_config

HPARAMS_NAME = "hparams.yaml"
STATE_DICT_NAME = "state_dict.pt"


def save_checkpoint(directory: str, state_dict: dict, config: Config):
    os.makedirs(directory, exist_ok=True)
    save_config(config, os.path.join(directory, HPARAMS_NAME))
    torch.save(state_dict, os.path.join(directory, STATE_DICT_NAME))


def load_checkpoint(directory: str, hparams_path: Optional[str] = None):
    """Returns (config, state_dict); an explicit `hparams_path` wins over
    the directory's own hparams.yaml (the reference's --hparams flag)."""
    config = load_config(hparams_path
                         or os.path.join(directory, HPARAMS_NAME))
    state_dict = torch.load(os.path.join(directory, STATE_DICT_NAME),
                            map_location="cpu", weights_only=True)
    return config, state_dict

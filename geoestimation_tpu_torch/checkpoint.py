"""The port's checkpoint directories.

Two layouts, each with the JAX package's `hparams.yaml` (`utils/config.py`)
at its root:

  * flat: `state_dict.pt`, the classifier's state dict (float32 tensors
    under torchvision's keys, see `convert.py`), as the converters write it;
  * training: one directory per step, `<step>/state.pt` ({"model": the
    state dict, "optimizer": its state, "step"}) and `<step>/metrics.json`,
    kept by `CheckpointManager` (the port of
    `geoestimation_tpu/train/checkpoint.py`: best-N by val_loss, the
    metric-less ones kept as resume points).

`load_checkpoint` reads either; from a training directory it takes the best
step by val_loss, else the latest, as the JAX `load_for_inference` does.

In several processes (`parallel/multihost.py`) process 0 writes and applies
the retention, and every process waits for it. Every tensor is whole in a
checkpoint, as the JAX package's orbax checkpoints hold global arrays: a
replica is written as process 0 holds it, and a fused head split over a
model axis, with its optimizer slots, is gathered whole first (`whole`, the
JAX package's `host_local_tree` fetch), so inference, the converters and a
resume under any layout (`cut`) read it as a one-axis run's.
"""

from __future__ import annotations

import json
import math
import os
import shutil
from typing import Any, Optional

import torch

from .parallel import multihost
from .utils.config import Config, load_config, save_config

HPARAMS_NAME = "hparams.yaml"
STATE_DICT_NAME = "state_dict.pt"
STEP_STATE_NAME = "state.pt"
STEP_METRICS_NAME = "metrics.json"


def save_checkpoint(directory: str, state_dict: dict, config: Config):
    os.makedirs(directory, exist_ok=True)
    save_config(config, os.path.join(directory, HPARAMS_NAME))
    torch.save(state_dict, os.path.join(directory, STATE_DICT_NAME))


def load_checkpoint(directory: str, hparams_path: Optional[str] = None,
                    step: Optional[int] = None):
    """Returns (config, state_dict); an explicit `hparams_path` wins over
    the directory's own hparams.yaml (the reference's --hparams flag). A
    training directory gives `step`'s model, by default the best step by
    val_loss, else the latest."""
    config = load_config(hparams_path
                         or os.path.join(directory, HPARAMS_NAME))
    flat = os.path.join(directory, STATE_DICT_NAME)
    if step is None and os.path.exists(flat):
        return config, torch.load(flat, map_location="cpu",
                                  weights_only=True)
    mgr = CheckpointManager(directory, create=False)
    if step is None:
        step = mgr.best_step() or mgr.latest_step()
    return config, mgr.restore(step)["model"]


def whole(tensors: dict, sharded: dict) -> dict:
    """`tensors` with each entry that `sharded` names (name -> the dim the
    model axis splits) gathered whole over the model group. Collective:
    every rank calls it with the same names."""
    return {k: multihost.gather_model(t, sharded[k]) if k in sharded else t
            for k, t in tensors.items()}


def cut(tensors: dict, sharded: dict, layout) -> dict:
    """Whole `tensors` with each entry that `sharded` names cut to this
    rank's slice under `layout` (`parallel.mesh.MeshLayout.shard`)."""
    return {k: layout.shard(t, sharded[k]).clone() if k in sharded else t
            for k, t in tensors.items()}


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    """Step-indexed checkpoints of {model, optimizer, step}, with best-N
    retention by `best_metric` (lower is better) when it is set, else the
    latest N. Checkpoints saved without metrics are kept as resume
    points."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 best_metric: Optional[str] = "val_loss", create=True):
        self.directory = os.path.abspath(os.path.expanduser(directory))
        if create:
            os.makedirs(self.directory, exist_ok=True)
        elif not os.path.isdir(self.directory):
            raise FileNotFoundError(f"no checkpoint directory "
                                    f"{self.directory!r}")
        self.max_to_keep = max_to_keep
        self.best_metric = best_metric

    def _path(self, step, name=""):
        return os.path.join(self.directory, str(step), name)

    def all_steps(self) -> list:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit()
                      and os.path.exists(self._path(d, STEP_STATE_NAME)))

    def metrics(self, step) -> Optional[dict]:
        with open(self._path(step, STEP_METRICS_NAME)) as f:
            return json.load(f)

    def save(self, step: int, state: dict, metrics: Optional[dict] = None,
             config: Optional[Any] = None) -> bool:
        """state: {"model", "optimizer", "step"}, moved to the CPU here.

        Saving a step that already exists is a no-op (returns False): the
        training loop reaches one step from several paths (periodic,
        epoch end, final). Non-finite metric values are dropped, and a
        save left with no metrics is exempt from best-N cleanup, so a
        SIGTERM checkpoint saved before any validation is kept. In several
        processes, process 0 writes, and every process waits for its answer
        (a broadcast, so a barrier too) and returns it."""
        saved = self._write(step, state, metrics, config) \
            if multihost.process_index() == 0 else None
        return multihost.broadcast_object(saved)

    def _write(self, step, state, metrics, config) -> bool:
        if step in self.all_steps():
            return False
        metrics = {k: float(v) for k, v in (metrics or {}).items()
                   if math.isfinite(float(v))} or None
        tmp = self._path(f"{step}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(_cpu(state), os.path.join(tmp, STEP_STATE_NAME))
        with open(os.path.join(tmp, STEP_METRICS_NAME), "w") as f:
            json.dump(metrics, f)
        os.replace(tmp, self._path(step))
        if config is not None:
            save_config(config, os.path.join(self.directory, HPARAMS_NAME))
        for old in self._steps_to_remove():
            shutil.rmtree(self._path(old))
        return True

    def _ranked(self):
        """(steps without metrics, steps with metrics from worst to best)."""
        steps = self.all_steps()
        scored = [(s, self.metrics(s)) for s in steps]
        without = [s for s, m in scored if m is None]
        ranked = sorted([(s, m) for s, m in scored if m is not None],
                        key=lambda sm: sm[1][self.best_metric], reverse=True)
        return without, [s for s, _ in ranked]

    def _steps_to_remove(self):
        steps = self.all_steps()
        if len(steps) <= self.max_to_keep:
            return []
        if not self.best_metric:
            return steps[:-self.max_to_keep] if self.max_to_keep else steps
        if not self.max_to_keep:
            return steps
        _, ranked = self._ranked()
        return ranked[:-self.max_to_keep]

    def restore(self, step: Optional[int] = None) -> dict:
        """`step`'s state (default: the latest), on the CPU."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoints under {self.directory!r}")
        return torch.load(self._path(step, STEP_STATE_NAME),
                          map_location="cpu", weights_only=True)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        """The step with the lowest `best_metric` (of equal ones, the
        latest), None when no step has metrics; the latest step when the
        manager keeps no metric."""
        if not self.best_metric:
            return self.latest_step()
        _, ranked = self._ranked()
        return ranked[-1] if ranked else None

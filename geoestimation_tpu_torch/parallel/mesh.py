"""Data-parallel device layout.

The counterpart of `geoestimation_tpu/parallel/mesh.py`. The JAX package's
mesh has a `data` axis (batch-sharded inputs, replicated parameters) and a
`model` axis for the fused head. The port keeps the data axis: in a
multi-process run it is the ranks in order, one card each; in one process it
is the local cards (or CPU devices, for the tests), each holding a replica,
over which a host batch is split (`shard_batch_arrays`). The model axis
(`n_model > 1`, the head sharded over it) and an outer data axis across
slices (`dcn_data > 1`) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from . import multihost

MODEL_AXIS_ITEM = "Model-axis head sharding"


@dataclass
class MeshLayout:
    """The data axis: each slot's device (as its process names it) and
    process index."""

    devices: tuple
    processes: tuple

    @property
    def n_data(self):
        return len(self.devices)

    def local_devices(self) -> list:
        """The devices of this process's slots, in order."""
        me = multihost.process_index()
        return [d for d, p in zip(self.devices, self.processes) if p == me]


def default_devices() -> list:
    """Every rank's device in a multi-process run; else the local cards.
    Raises where CUDA is absent: a caller that means the CPU passes its
    devices."""
    if multihost.process_count() > 1:
        return multihost.rank_devices()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(CLI: --cpu) to run on the CPU")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None,
              dcn_data: int = 1) -> MeshLayout:
    """The (data, model) layout over `devices`, this process's own (default:
    `default_devices`, the ranks in a multi-process run), validated with
    the JAX package's messages. n_data=None puts every device on the data
    axis. Refuses n_model > 1 and dcn_data > 1 by name."""
    ranks = devices is None and multihost.process_count() > 1
    devices = list(devices if devices is not None else default_devices())
    total = len(devices)
    if n_data is None:
        if total % n_model:
            raise ValueError(f"{total} devices not divisible by "
                             f"model={n_model}")
        n_data = total // n_model
    if n_data * n_model != total:
        raise ValueError(f"mesh {n_data}x{n_model} != {total} devices")
    if dcn_data > 1 and n_data % dcn_data:
        raise ValueError(
            f"data axis {n_data} not divisible by dcn_data={dcn_data}")
    if n_model > 1 or dcn_data > 1:
        raise NotImplementedError(
            f"mesh (n_model={n_model}, dcn_data={dcn_data}) is not ported "
            f"yet (ROADMAP.md Queue 1, {MODEL_AXIS_ITEM!r}); the port "
            "shards the data axis only")
    processes = (tuple(range(total)) if ranks
                 else (multihost.process_index(),) * total)
    return MeshLayout(devices=tuple(torch.device(d) for d in devices),
                      processes=processes)


def shard_batch_arrays(layout: MeshLayout, images):
    """Split a host batch (batch axis 0) evenly over the layout's local
    devices: one tensor on each."""
    devices = layout.local_devices()
    b = np.shape(images)[0]
    if b % len(devices):
        raise ValueError(f"batch of {b} does not split evenly over the "
                         f"layout's {len(devices)} devices")
    return [torch.as_tensor(x).to(d, non_blocking=True)
            for x, d in zip(np.split(np.asarray(images), len(devices)),
                            devices)]

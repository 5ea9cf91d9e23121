"""Device layout: a data axis and a model axis over the ranks.

The counterpart of `geoestimation_tpu/parallel/mesh.py`. The JAX package's
mesh has a `data` axis (batch-sharded inputs, replicated parameters) and a
`model` axis for the fused head; the port lays the same (data, model) grid
over its slots, slot s at (s // n_model, s % n_model), as
`np.array(devices).reshape(n_data, n_model)` does:

  * in a multi-process run each rank is one slot, rank r at
    (r // n_model, r % n_model). The ranks of one data index see the same
    rows of the global batch; the ranks of one model index (its data group)
    hold the same slice of the fused head. `make_mesh` forms those groups
    (`multihost.mesh_groups`); within `MeshLayout.active()` the BatchNorm
    statistics, the valid counts and the gradients are summed over the
    data group;
  * in one process the slots are the local cards (or CPU devices, for the
    tests), each a replica over which a host batch is split
    (`shard_batch_arrays`); there is no rank to hold a head slice, so the
    model axis needs several processes.

Every parameter is replicated except the fused head, `heads.fused_head`
(Σclasses x 2048 in torch's (out, in) layout): with Σ divisible by n_model
its classes (rows of the weight, and the bias) are split over the model
axis (`head_kernel`, `head_bias`), else its 2048 features (columns of the
weight), the bias then replicated. Momentum follows its parameter. An outer
data axis across slices (`dcn_data > 1`) splits the data axis into
`dcn_data` groups of consecutive data indices: the gradient all-reduce
runs inside each group, then across the groups.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from . import multihost

HEAD = "fused_head"


@dataclass
class MeshLayout:
    """The (data, model) grid: each slot's device (as its process names it)
    and process index, slot s at (s // n_model, s % n_model)."""

    devices: tuple
    processes: tuple
    n_model: int = 1
    dcn_data: int = 1
    groups: Optional[multihost.MeshGroups] = None   # over the ranks

    def active(self):
        """A context in which the collectives run over this layout's groups
        (`multihost.on_mesh`; a no-op without ranks)."""
        return multihost.on_mesh(self.groups)

    @property
    def n_data(self):
        return len(self.devices) // self.n_model

    def local_devices(self) -> list:
        """The devices of this process's slots, in order."""
        me = multihost.process_index()
        return [d for d, p in zip(self.devices, self.processes) if p == me]

    def _slot(self) -> int:
        return self.processes.index(multihost.process_index())

    @property
    def data_index(self) -> int:
        """This process's position on the data axis (its first slot's)."""
        return self._slot() // self.n_model

    @property
    def model_index(self) -> int:
        """This process's position on the model axis (its first slot's)."""
        return self._slot() % self.n_model

    # -- placement of the fused head -------------------------------------------

    def head_kernel(self, n_total: int) -> Optional[int]:
        """The dim of the fused head's (n_total, features) weight that the
        model axis splits: 0 (the classes) when n_total divides evenly,
        else 1 (the features, so an odd class count such as the real
        23,393 still spreads its weight and momentum); None on a model
        axis of one."""
        if self.n_model == 1:
            return None
        return 1 if n_total % self.n_model else 0

    def head_bias(self, n_total: int) -> Optional[int]:
        """The bias rides the class split only; with the features split it
        is replicated (4 bytes a class)."""
        return 0 if self.head_kernel(n_total) == 0 else None

    def params(self, tensors: dict) -> dict:
        """{name: the dim the model axis splits, or None (replicated)} for
        a state dict or `named_parameters()` of a classifier: the fused
        head's weight and bias by `head_kernel` / `head_bias`, everything
        else replicated. Shapes are the whole tensors'."""
        out = {}
        for name, t in tensors.items():
            dim = None
            if HEAD in name.split("."):
                if t.dim() == 2:
                    dim = self.head_kernel(t.shape[0])
                elif t.dim() == 1:
                    dim = self.head_bias(t.shape[0])
            out[name] = dim
        return out

    def shard(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This process's slice of a whole tensor along `dim` (the tensor
        itself for None)."""
        if dim is None:
            return t
        n = t.shape[dim]
        if n % self.n_model:
            raise ValueError(f"the fused head's dim {dim} ({n}) does not "
                             f"split over model={self.n_model}")
        k = n // self.n_model
        return t.narrow(dim, self.model_index * k, k)


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


def require_ranks(n_data, n_model: int):
    """Raises unless the model axis is one: a rank holds each slice of the
    head, so a model axis needs --coordinator's processes."""
    if n_model > 1:
        raise ValueError(
            f"mesh {n_data}x{n_model}: the model axis splits the fused head "
            f"over {n_model} ranks, one process each; launch "
            f"{(n_data or 1) * n_model} processes with --coordinator "
            "(--num_processes, --process_id)")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None,
              dcn_data: int = 1) -> MeshLayout:
    """The (data, model) layout over `devices`, this process's own (default:
    `default_devices`, the ranks in a multi-process run), validated with
    the JAX package's messages. n_data=None puts every device not on the
    model axis on the data axis. Over the ranks it also forms the layout's
    process groups (`multihost.mesh_groups`; every rank calls it alike),
    which `MeshLayout.active()` puts to use. A model axis needs a rank a
    slot: in one process it raises, naming --coordinator, before any other
    check."""
    ranks = devices is None and multihost.process_count() > 1
    if not ranks:
        require_ranks(n_data, n_model)
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
    processes = (tuple(range(total)) if ranks
                 else (multihost.process_index(),) * total)
    return MeshLayout(
        devices=tuple(torch.device(d) for d in devices),
        processes=processes, n_model=n_model, dcn_data=dcn_data,
        groups=(multihost.mesh_groups(n_data, n_model, dcn_data) if ranks
                else None))


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

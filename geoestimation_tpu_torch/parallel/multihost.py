"""Multi-process runtime of the port, on torch.distributed.

The counterpart of `geoestimation_tpu/parallel/multihost.py`. Every process
runs the SAME program and holds a full replica of the parameters and only
its own rows of each batch; `initialize` joins the processes into one group
of ranks. Two process groups:

  * the host group (gloo, the default group): numpy-sized agreements --
    have-next bits, GCD counts, validation sums, the SIGTERM flag;
  * the device group: BatchNorm statistics, the loss's valid counts and the
    gradients. It runs on NCCL where every rank has a card of its own, and
    on gloo where two ranks share a card or the run is on the CPU (gloo
    carries CUDA tensors through host memory; the compute stays on the
    card). Which case holds is decided once at start-up from every rank's
    (host name, card UUID).

What replaces the JAX package's global arrays: a process feeds its own rows
as they are (`global_batch_array` has no counterpart), rank 0's state is
broadcast at the start and after a resume (`broadcast_tensors`, for
`global_put_tree`), and rank 0 writes checkpoints (`checkpoint.
CheckpointManager`, for `host_local_tree`), the fused head gathered first
where the model axis splits it (`gather_model`).

With a model axis (`mesh.make_mesh(n_data, n_model)`, n_model > 1) rank r
sits at (r // n_model, r % n_model) and `mesh_groups` forms, on the device
group's backend, each rank's data group (the ranks of its model index) and
model group (the ranks of its data index), and with `dcn_data` > 1 the
inner and outer data groups of a two-level all-reduce. While a layout's
groups are active (`on_mesh`, which `train.loop.Trainer` enters around its
work) the data-axis sums (BatchNorm statistics, valid counts, metrics,
gradients) run over the data group: model-axis peers hold the same rows,
so a sum over every rank would count them n_model times. The fused head's
forward calls the model-axis collectives (`model_copy`, `model_gather`,
`model_slice`, `model_sum`, each an autograd function), and the gradient
all-reduce hands model-axis peers the same replicated gradients.

Launch, one command per process:

  python -m geoestimation_tpu_torch.classification.train_base \\
      --config configs/baseM.yml --coordinator HOST:PORT \\
      --num_processes N --process_id P

or under `torchrun --nproc_per_node N -m ...` with `--coordinator auto`
(init_method env://: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). A process
without --cpu runs on `cuda:{P % torch.cuda.device_count()}`. Collectives
wait at most `initialize`'s `timeout_s` (DEFAULT_TIMEOUT_S, 1800) seconds
for a peer. The ranks of one host can also come from `launch.Ranks`, which
holds the rendezvous store and starts the clock once every rank is there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import launch

DEFAULT_TIMEOUT_S = 1800.0


@dataclasses.dataclass
class Runtime:
    """What `initialize` set up in this process."""

    device_group: object        # NCCL or gloo group of every rank
    backend: str                # the device group's backend
    device: torch.device        # this process's device
    rank_devices: list          # each rank's device, as that rank names it
    timeout: datetime.timedelta  # a collective's longest wait
    mesh: Optional["MeshGroups"] = None   # the groups `on_mesh` activated
    meshes: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class MeshGroups:
    """This rank's process groups under one (data, model, dcn) layout; a
    group of one rank is None (its collectives are no-ops)."""

    data_index: int             # this rank's place on the data axis
    n_data: int
    data: object                # the ranks of this rank's model index
    model: object               # the ranks of this rank's data index
    inner: object = None        # dcn: this rank's slice of its data group
    outer: object = None        # dcn: its peers in the other slices


_runtime: Optional[Runtime] = None


def _device_for(rank: int, cpu: bool) -> torch.device:
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --cpu to run the "
                           "processes on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _card_id(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    props = torch.cuda.get_device_properties(device)
    return str(getattr(props, "uuid", f"index {device.index}"))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, cpu: bool = False,
               timeout_s: Optional[float] = None) -> Runtime:
    """Join (or form) the group of ranks: `init_process_group` on
    `tcp://<coordinator_address>` with `num_processes` and `process_id`, or
    on env:// (torchrun's variables) without an address. Then the device
    group: NCCL where every rank is on a card of its own, else gloo. Raises
    if any of it fails; prints the backend once, on rank 0."""
    global _runtime
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    timeout = datetime.timedelta(seconds=float(
        timeout_s or DEFAULT_TIMEOUT_S))
    if coordinator_address is None:
        init, kw = "env://", {}
        rank = int(os.environ.get("RANK", 0))
    else:
        init = f"tcp://{coordinator_address}"
        kw = dict(world_size=num_processes, rank=process_id)
        rank = process_id
    # before the rendezvous: a rank without its card fails alone and early
    device = _device_for(rank, cpu)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if init != "env://" and os.environ.get(
            launch.STORE_ENV) == coordinator_address:
        # a rank of `launch.Ranks`: its store, once every rank is there
        dist.init_process_group("gloo", store=launch.meet(
            coordinator_address, num_processes, timeout), timeout=timeout,
            **kw)
    else:
        dist.init_process_group("gloo", init_method=init, timeout=timeout,
                                **kw)
    world = dist.get_world_size()
    idents = [None] * world
    dist.all_gather_object(idents, (socket.gethostname(), _card_id(device),
                                    str(device)))
    cards = [(host, card) for host, card, _ in idents]
    on_cards = all(card != "cpu" for _, card in cards)
    own_card = len(set(cards)) == world
    backend = ("nccl" if on_cards and own_card and dist.is_nccl_available()
               else "gloo")
    device_group = dist.new_group(backend=backend, timeout=timeout)
    _runtime = Runtime(device_group=device_group, backend=backend,
                       device=device,
                       rank_devices=[torch.device(d) for _, _, d in idents],
                       timeout=timeout)
    if dist.get_rank() == 0:
        why = ("every rank has a card of its own" if backend == "nccl"
               else "on the CPU" if not on_cards
               else "ranks share a card" if not own_card
               else "NCCL is not available")
        print(f"torch.distributed: {world} processes; host group gloo, "
              f"device group {backend} ({why})", flush=True)
    return _runtime


def add_coordinator_args(parser, extra_help=""):
    """The shared multi-process flag trio, identical across
    classification.{train_base,inference,test}."""
    parser.add_argument(
        "--coordinator", default=None,
        help="multi-process runtime: coordinator host:port (launch one "
             "process per host with its own --process_id), or 'auto' "
             "for the env:// variables torchrun sets; see README.md. "
             f"{extra_help}".strip())
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)


def maybe_initialize(args) -> bool:
    """Wire torch.distributed from `add_coordinator_args` flags (and
    `--cpu`); True if it did. No-op without --coordinator; orphan
    --num_processes/--process_id (which would otherwise be silently
    ignored) are rejected."""
    if not args.coordinator:
        if args.num_processes is not None or args.process_id is not None:
            raise SystemExit(
                "--num_processes/--process_id require --coordinator")
        return False
    cpu = bool(getattr(args, "cpu", False))
    if args.coordinator == "auto":
        initialize(cpu=cpu)
        return True
    if args.num_processes is None or args.process_id is None:
        raise SystemExit("--coordinator HOST:PORT needs --num_processes and "
                         "--process_id (or --coordinator auto under "
                         "torchrun)")
    initialize(args.coordinator, args.num_processes, args.process_id,
               cpu=cpu)
    return True


@contextlib.contextmanager
def joined(args):
    """`maybe_initialize(args)` for the body of a CLI, and `shutdown` after
    it when it initialized."""
    started = maybe_initialize(args)
    try:
        yield
    finally:
        if started:
            shutdown()


def shutdown():
    """Leave the group (no-op without one)."""
    global _runtime
    if dist.is_initialized():
        dist.destroy_process_group()
    _runtime = None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def runtime() -> Optional[Runtime]:
    return _runtime


def local_device(cpu: bool = False):
    """This process's device: the one `initialize` chose, else 'cpu' with
    `cpu`, else 'cuda'."""
    if _runtime is not None:
        return _runtime.device
    return "cpu" if cpu else "cuda"


def rank_devices() -> list:
    """Every rank's device in rank order, as each rank names it."""
    return list(_runtime.rank_devices) if _runtime is not None else []


def device_group():
    """The device group, or None in one process."""
    if _runtime is None or process_count() == 1:
        return None
    return _runtime.device_group


def mesh_groups(n_data: int, n_model: int, dcn_data: int = 1) -> MeshGroups:
    """This rank's groups of the (n_data, n_model) layout, rank r at
    (r // n_model, r % n_model), with dcn_data slices of consecutive data
    indices, formed once per shape. Collective: every rank calls it with
    the same shape (`torch.distributed.new_group` is called for every
    group, in one order, on every rank). `on_mesh` makes them the ones the
    collectives use."""
    key = (n_data, n_model, dcn_data)
    if key not in _runtime.meshes:
        _runtime.meshes[key] = _form_groups(*key)
    return _runtime.meshes[key]


@contextlib.contextmanager
def on_mesh(groups: Optional[MeshGroups]):
    """Within the block the data-axis sums, the gradient all-reduce and the
    model-axis collectives run over `groups` (a no-op for None, as in one
    process); the groups active before are restored after it."""
    if groups is None:
        yield
        return
    before = _runtime.mesh
    _runtime.mesh = groups
    try:
        yield
    finally:
        _runtime.mesh = before


def _form_groups(n_data, n_model, dcn_data):
    me = process_index()

    def group(ranks):
        ranks = list(ranks)
        g = dist.new_group(ranks=ranks, backend=_runtime.backend,
                           timeout=_runtime.timeout)
        return g if me in ranks and len(ranks) > 1 else None

    def mine(groups):
        return next((g for g in groups if g is not None), None)

    if n_model == 1:
        data = _runtime.device_group
        model = None
    else:
        data = mine([group(range(m, n_data * n_model, n_model))
                     for m in range(n_model)])
        model = mine([group(range(d * n_model, (d + 1) * n_model))
                      for d in range(n_data)])
    inner = outer = None
    if dcn_data > 1:
        per = n_data // dcn_data
        inner = mine([group([(o * per + i) * n_model + m
                             for i in range(per)])
                      for m in range(n_model) for o in range(dcn_data)])
        outer = mine([group([(o * per + i) * n_model + m
                             for o in range(dcn_data)])
                      for m in range(n_model) for i in range(per)])
    return MeshGroups(me // n_model, n_data, data, model, inner, outer)


def data_group():
    """The group the data-axis sums run over: the active layout's data
    group, else the device group; None in one process (or a data axis of
    one)."""
    if _runtime is None or process_count() == 1:
        return None
    if _runtime.mesh is not None:
        return _runtime.mesh.data
    return _runtime.device_group


def data_shard() -> tuple:
    """(this rank's data index, the data axis's size): the rows of the
    global batch it feeds. (process_index(), process_count()) without an
    active layout."""
    if _runtime is not None and _runtime.mesh is not None:
        return _runtime.mesh.data_index, _runtime.mesh.n_data
    return process_index(), process_count()


def model_group():
    """The active layout's model group; None without a model axis (or
    without an active layout)."""
    if _runtime is None or _runtime.mesh is None:
        return None
    return _runtime.mesh.model


# -- collectives --------------------------------------------------------------

def _host_reduce(values, op):
    if process_count() == 1:
        return np.asarray(values)
    t = torch.as_tensor(np.asarray(values)).clone()
    dist.all_reduce(t, op=op)
    return t.numpy()


def host_sum(values) -> np.ndarray:
    """Elementwise sum of a numpy array over every rank (host group)."""
    return _host_reduce(values, dist.ReduceOp.SUM)


def host_any(flag: bool) -> bool:
    """True on every rank iff `flag` is true on one (an int MAX)."""
    return bool(_host_reduce(np.int64(bool(flag)), dist.ReduceOp.MAX))


def host_all(flag: bool) -> bool:
    """True on every rank iff `flag` is true on all (an int MIN)."""
    return bool(_host_reduce(np.int64(bool(flag)), dist.ReduceOp.MIN))


def device_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of `t` over the data axis (`data_group`), outside autograd; `t`
    itself in one process."""
    group = data_group()
    if group is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=group)
    return t


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The train-mode BatchNorm's per-channel sums of x and of x^2 and its
    element count summed over the data axis (`data_group`), outside
    autograd (`sum_bn_grads` sums their gradients in the backward); `t`
    itself in one process."""
    group = data_group()
    if group is None:
        return t
    t = t.clone()
    dist.all_reduce(t, group=group)
    return t


def sum_bn_grads(t: torch.Tensor) -> torch.Tensor:
    """The train-mode BatchNorm backward's gradients with respect to the
    sums that `sum_over_ranks` summed, per channel, summed over the data
    axis (`data_group`), outside autograd: every rank's statistics depend
    on every rank's rows. `t` itself in one process."""
    group = data_group()
    if group is None:
        return t
    t = t.clone()
    dist.all_reduce(t, group=group)
    return t


def _through_flat(grads, collective):
    """Run `collective` on the gradients flattened into one tensor, then
    copy the result back into each."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    collective(flat)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def all_reduce_grads(params):
    """Sum every parameter's gradient over the data axis: one all-reduce of
    the flattened gradients on the data group, or with `dcn_data` > 1 one
    inside each slice's inner group and then one across the slices (no-op
    in one process). A head slice's data group holds that slice, so every
    gradient, sharded or not, is summed the same way. With a model axis the
    replicated gradients (every parameter not marked `model_split`) are
    then broadcast from the model group's first rank, so model-axis peers
    step with the same bits whatever their own backward and sums gave, as
    the JAX package's mesh holds one value of a replicated leaf."""
    mesh = _runtime.mesh if _runtime is not None else None
    groups = ([mesh.inner, mesh.outer] if mesh is not None
              and (mesh.inner is not None or mesh.outer is not None)
              else [data_group()])
    groups = [g for g in groups if g is not None]
    if groups:
        def reduce(flat):
            for group in groups:
                dist.all_reduce(flat, group=group)
        _through_flat([p.grad for p in params], reduce)
    model = model_group()
    replicated = [p.grad for p in params
                  if not getattr(p, "model_split", False)]
    if model is not None and replicated:
        src = dist.get_global_rank(model, 0)
        _through_flat(replicated, lambda flat: dist.broadcast(
            flat, src=src, group=model))


# -- the model axis -------------------------------------------------------------

def _gather_last(x, group):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def _own_slice(x, group):
    k = x.shape[-1] // dist.get_world_size(group)
    return x.narrow(-1, dist.get_rank(group) * k, k)


class _ModelCopy(torch.autograd.Function):
    """y = x on every model rank; the gradient is summed over the model
    group, since each rank's slice of the head sees x."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ModelGather(torch.autograd.Function):
    """y = every model rank's x side by side on the last dim; the backward
    hands each rank its slice (every rank's loss is the same function of
    y, so each holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _own_slice(grad, ctx.group).contiguous(), None


class _ModelSlice(torch.autograd.Function):
    """y = this model rank's slice of x's last dim; the backward gathers
    the slices' gradients, so every rank holds x's whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _own_slice(x, group).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather_last(grad, ctx.group), None


class _ModelSum(torch.autograd.Function):
    """y = the sum of x over the model group (partial products); the
    gradient passes as it is (every rank's loss is the same function of
    y)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _on_model_axis(fn):
    def apply(x):
        group = model_group()
        return x if group is None else fn.apply(x, group)
    apply.__doc__ = fn.__doc__
    return apply


model_copy = _on_model_axis(_ModelCopy)
model_gather = _on_model_axis(_ModelGather)
model_slice = _on_model_axis(_ModelSlice)
model_sum = _on_model_axis(_ModelSum)


def gather_model(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole tensor from every model rank's slice along `dim` (outside
    autograd); `t` itself without a model axis. Collective over the model
    group."""
    group = model_group()
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.detach().contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def broadcast_tensors(tensors, sharded=()):
    """Overwrite `tensors` on every rank with rank 0's, on the device group:
    the port's `global_put_tree` (placing the state is making the replicas
    equal). `sharded` tensors, each rank's slice of a head, take the slice
    of the data group's first rank (the same model index) instead."""
    group = device_group()
    if group is None:
        return
    for t in tensors:
        dist.broadcast(t, src=0, group=group)
    data = data_group()
    if data is not None:
        for t in sharded:
            dist.broadcast(t, src=dist.get_global_rank(data, 0), group=data)


def broadcast_object(obj):
    """Rank 0's picklable `obj` on every rank (host group)."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


# -- feeds --------------------------------------------------------------------

class LockstepSlicer:
    """Wrap a batcher that yields identical GLOBAL batches on every process
    (same shards, same seed, host_count=1) and emit this process's
    contiguous slice of each: rows [p*local : (p+1)*local], where p is the
    process's data index and the count the data axis's size (the ranks in
    order, `mesh.make_mesh`; model-axis peers take the same rows)."""

    def __init__(self, batcher, process_id: int, process_count: int):
        if batcher.batch_size % process_count:
            raise ValueError(
                f"global batch {batcher.batch_size} not divisible by "
                f"{process_count} processes")
        self.batcher = batcher
        self.p = process_id
        self.n = process_count
        self.local = batcher.batch_size // process_count

    def __iter__(self):
        lo = self.p * self.local
        hi = lo + self.local
        for b in self.batcher:
            yield dataclasses.replace(
                b,
                images=b.images[lo:hi],
                labels=b.labels[:, lo:hi],
                ids=None if b.ids is None else b.ids[lo:hi],
                latlng=None if b.latlng is None else b.latlng[lo:hi],
                scene=None if b.scene is None else b.scene[lo:hi],
            )


class StridedFeed:
    """Per-process shard-subset feed (`train_params.data_feed: strided`):
    each process reads only its shard subset (`shards[p::n]`) and decodes
    only its LOCAL rows, at the price of global batch composition
    differing from a single-process run (rows pair by arrival order).

    Uneven shard subsets would hand processes different batch counts and
    leave one waiting in the next collective; every yield is therefore
    gated on a have-next bit agreed on the host group, and the stream ends
    GLOBALLY as soon as any process runs dry."""

    def __init__(self, batcher):
        self.batcher = batcher
        self.batch_size = batcher.batch_size

    def __iter__(self):
        it = iter(self.batcher)
        while True:
            err = None
            try:
                b = next(it)
            except StopIteration:
                b = None
            except Exception as e:  # decode/IO failure on THIS process
                # still vote have=False so the peers leave cleanly instead
                # of waiting to the timeout; re-raise here after the vote
                b, err = None, e
            have = host_all(b is not None)
            if err is not None:
                raise err
            if not have:
                return
            yield b


# -- evaluation ---------------------------------------------------------------

def merge_gcd_accumulators(accs: dict, n_missing: int = 0) -> int:
    """Cross-process reduction for multi-process evaluation: sum every
    process's GCD threshold counts and totals into each accumulator IN
    PLACE (one int64 all-reduce on the host group) and return the summed
    images-without-meta count. Every process calls this in lockstep with
    the same key set, an idle one (an empty file slice) too."""
    keys = sorted(accs)
    t = len(next(iter(accs.values())).counts)
    local = np.concatenate(
        [np.concatenate([accs[k].counts, [accs[k].total]]) for k in keys]
        + [[n_missing]]
    ).astype(np.int64)
    summed = host_sum(local)
    off = 0
    for k in keys:
        accs[k].counts = summed[off:off + t]
        accs[k].total = int(summed[off + t])
        off += t + 1
    return int(summed[-1])


def data_axis_is_process_contiguous(layout) -> bool:
    """True iff walking the layout's data axis (the first slot of each data
    index) visits processes in non-decreasing, contiguous blocks -- the
    layout `LockstepSlicer`'s contiguous row slices assume."""
    seen = []
    for p in layout.processes[::layout.n_model]:
        if not seen or seen[-1] != p:
            if p in seen:
                return False
            seen.append(p)
    return True

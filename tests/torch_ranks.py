"""Rank bodies of the port's multi-process CPU tests.

`start` starts `world` ranks of their own (`launch.Ranks`: forked from a
forkserver that has imported torch and the port once, joined in a gloo
group on the CPU with a 30 s collective timeout only once every rank is
there, one torch thread, the TensorBoard import failed), each running one
of the bodies below, which write what they saw under `out_dir`. A world
ends at its own time limit, counted from its start. This module imports no
JAX.
"""

import contextlib
import os

import numpy as np
import torch

from geoestimation_tpu_torch.parallel import launch

N_CLASSES = (3, 5, 9)
ARCH = "resnet14"
TIMEOUT_S = 30       # a collective's longest wait
LIMIT_S = 120        # a world's, from its start


def start(fn, out_dir, *args, world=2, limit_s=LIMIT_S):
    """Start fn(rank, world, out_dir, *args) in `world` ranks."""
    return launch.Ranks(world, limit_s).start(fn, str(out_dir), *args,
                                              timeout_s=TIMEOUT_S)


def join(ranks):
    """Wait for `start`'s ranks; raise with the tracebacks if a rank failed
    (TimeoutError, the ranks killed, past the world's limit)."""
    errors = [f"rank {r} exit {code}:\n{out}"
              for r, (code, out) in enumerate(ranks.wait()) if code != 0]
    if errors:
        raise AssertionError("\n".join(errors))


def spawn(fn, out_dir, *args, world=2, limit_s=LIMIT_S):
    join(start(fn, out_dir, *args, world=world, limit_s=limit_s))


# -- collectives --------------------------------------------------------------

class _Batch:
    def __init__(self, k):
        self.k = k


class _Stream:
    """A batcher of `n` items that raises at item `fail_at`."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at, self.batch_size = n, fail_at, 1

    def __iter__(self):
        for k in range(self.n):
            if k == self.fail_at:
                raise OSError(f"decode failed at {k}")
            yield _Batch(k)


def collectives(rank, world, out_dir, gcd_counts):
    """StridedFeed on uneven streams (rank r has 3 + 2r batches) and with a
    decode error on rank 1 at its second batch; merge_gcd_accumulators of
    this rank's counts; the host-group flags."""
    from geoestimation_tpu_torch.eval.metrics import GcdAccumulator
    from geoestimation_tpu_torch.parallel import multihost

    seen = {"uneven": [b.k for b in multihost.StridedFeed(
        _Stream(3 + 2 * rank))]}
    got = []
    try:
        for b in multihost.StridedFeed(
                _Stream(5, fail_at=1 if rank == 1 else None)):
            got.append(b.k)
    except OSError as e:
        seen["error"] = str(e)
    seen["before_error"] = got
    accs = {}
    for key, rows in gcd_counts[rank].items():
        acc = accs[key] = GcdAccumulator()
        for counts, total in rows:
            acc.update(np.asarray(counts), total)
    seen["n_missing"] = multihost.merge_gcd_accumulators(accs, 3 + rank)
    seen["merged"] = {k: (a.counts.tolist(), a.total)
                      for k, a in accs.items()}
    seen["any"] = [multihost.host_any(rank == 1), multihost.host_any(False)]
    seen["all"] = [multihost.host_all(rank == 1), multihost.host_all(True)]
    torch.save(seen, os.path.join(out_dir, f"collectives{rank}.pt"))


# -- train steps --------------------------------------------------------------

def seeded_state(remat=False, n_scenes=None, n_classes=N_CLASSES,
                 layout=None):
    """The seeded float32 weights of tests/test_torch_port_train.py's
    `_states`, as the port's TrainState (SGD lr 0.05, momentum 0.9, weight
    decay 1e-4, constant schedule); with `layout`, the fused head cut to
    this rank's slice before the optimizer is built."""
    from geoestimation_tpu_torch.convert import from_jax_variables
    from geoestimation_tpu_torch.models import classifier
    from geoestimation_tpu_torch.models.isn import ISNClassifier
    from geoestimation_tpu_torch.tools import world
    from geoestimation_tpu_torch.train import optim, step
    from geoestimation_tpu_torch.utils.config import (
        LRScheduleConfig,
        OptimizerConfig,
    )

    rng = np.random.default_rng(5)
    params, stats = world.seeded_jax_variables(rng, ARCH, n_classes,
                                               n_scenes)
    if n_scenes:
        model = ISNClassifier(n_classes, n_scenes, ARCH, torch.float32,
                              remat=remat)
    else:
        model = classifier.MultiPartitioningClassifier(
            n_classes, ARCH, torch.float32, remat=remat)
    model.load_state_dict(from_jax_variables(params, stats, ARCH, n_classes))
    if layout is not None:
        model.shard_(layout)
    opt = OptimizerConfig(lr=0.05, momentum=0.9, weight_decay=1e-4)
    return step.TrainState(model, optim.build_optimizer(
        model.parameters(), opt, LRScheduleConfig(name="constant"), 10))


def train_steps(rank, world, out_dir, images, labels, scene, draws, crop):
    """This rank's rows of the global batch through two train steps (the
    center crop, then `draws`' augmentation, given for the global batch),
    plain and with remat, and one ISN step; saves each state dict and the
    metrics."""
    from geoestimation_tpu_torch.ingest.pipeline import draw_rows
    from geoestimation_tpu_torch.train import step

    local = images.shape[0] // world
    lo, hi = rank * local, (rank + 1) * local
    x = torch.from_numpy(images[lo:hi])
    y = torch.from_numpy(labels[:, lo:hi])
    mine = draw_rows({k: v if k == "size" else torch.from_numpy(v)
                      for k, v in draws.items()}, lo, hi)
    out = {}
    for name, remat in (("plain", False), ("remat", True)):
        state = seeded_state(remat=remat)
        metrics = []
        for augment in (False, True):
            state, m = step.train_step(state, x, y, 0, crop=crop,
                                       augment=augment,
                                       draws=mine if augment else None)
            metrics.append({k: float(v) for k, v in m.items()})
        out[name] = (state.model.state_dict(), metrics)
    state = seeded_state(n_scenes=3)
    state, m = step.train_step_isn(state, x, y, torch.from_numpy(
        scene[lo:hi]), 0, crop=crop, scene_loss_weight=0.5, augment=False)
    out["isn"] = (state.model.state_dict(),
                  [{k: float(v) for k, v in m.items()}])
    torch.save(out, os.path.join(out_dir, f"steps{rank}.pt"))


def sigterm_fit(rank, world, out_dir, config_path):
    """Trainer.fit for 6 steps where rank 1 alone receives SIGTERM during its
    first step; saves the step each rank returned at and rank 0's log."""
    import signal

    from geoestimation_tpu_torch.train import loop
    from geoestimation_tpu_torch.utils.config import load_config

    step = loop.train_step

    def signalled(state, *a, **k):
        out = step(state, *a, **k)
        if rank == 1 and state.step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    loop.train_step = signalled
    lines = []
    config = load_config(config_path)
    config.train_params.checkpoint_dir = os.path.join(out_dir, "ckpt")
    state = loop.Trainer(config, log_fn=lines.append, device="cpu").fit(
        max_steps=6, resume=False)
    torch.save({"step": state.step, "log": lines},
               os.path.join(out_dir, f"sigterm{rank}.pt"))


# -- the model axis -------------------------------------------------------------

# the steps of `model_axis_steps`: center crops, then the draws of
# (seed 0, step 1) for the global batch
AUGMENT = (False, True)


@contextlib.contextmanager
def _unreduced_feature_grad(planted):
    """Where `planted`, a fault for the block: the features' gradient is
    not summed (classes split) or not gathered (features split) over the
    model group."""
    from geoestimation_tpu_torch.parallel import multihost

    saved = multihost.model_copy, multihost.model_slice
    if planted:
        multihost.model_copy = lambda x: x
        multihost.model_slice = lambda x: multihost._own_slice(
            x, multihost.model_group())
    try:
        yield
    finally:
        multihost.model_copy, multihost.model_slice = saved


def model_axis_steps(rank, world, out_dir, shapes, n_classes, images,
                     labels, crop):
    """For each named mesh shape (n_data, n_model[, dcn_data]), inside its
    layout's `active()` block: the seeded state with its head cut to this
    rank's slice, the train steps of `AUGMENT` on this rank's data-index
    rows, the metrics, the head slices' shapes, and the state after each
    step gathered whole (parameters, statistics and momentum, as a
    checkpoint holds them). The first shape's last state is also saved by
    `CheckpointManager`, restored and cut again, and whether the cut equals
    the live slices bitwise. A shape named "fault" takes the first step
    alone, with `_unreduced_feature_grad` planted."""
    from geoestimation_tpu_torch.parallel import mesh

    out = {}
    for name, shape in shapes.items():
        layout = mesh.make_mesh(*shape[:2], dcn_data=(*shape, 1)[2])
        fault = name == "fault"
        with layout.active(), _unreduced_feature_grad(fault):
            state, out[name] = _steps_on(
                layout, n_classes, images, labels, crop,
                AUGMENT[:1] if fault else AUGMENT)
            if name == next(iter(shapes)):
                out[name]["recut_equal"] = _recut_equal(
                    layout, state, out[name], out_dir)
    torch.save(out, os.path.join(out_dir, f"model_axis{rank}.pt"))


def _steps_on(layout, n_classes, images, labels, crop, augments):
    from geoestimation_tpu_torch.checkpoint import whole
    from geoestimation_tpu_torch.train import step

    def gathered(state, sharded):
        names = [k for k, _ in state.model.named_parameters()]
        return {k: {n: t.clone() for n, t in whole(d, sharded).items()}
                for k, d in (("model", state.model.state_dict()),
                             ("trace", dict(zip(
                                 names, state.optimizer.slots["trace"]))))}

    full = seeded_state(n_classes=n_classes).model
    sharded = {k: d for k, d in layout.params(
        dict(full.named_parameters())).items() if d is not None}
    state = seeded_state(n_classes=n_classes, layout=layout)
    per = images.shape[0] // layout.n_data
    lo = layout.data_index * per
    x = torch.from_numpy(images[lo:lo + per])
    y = torch.from_numpy(labels[:, lo:lo + per])
    metrics, states = [], []
    for augment in augments:
        state, m = step.train_step(state, x, y, 0, crop=crop,
                                   augment=augment)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(gathered(state, sharded))
    head = state.model.heads.fused_head
    return state, {
        "metrics": metrics, "after": states, "sharded": sharded,
        "coords": (layout.data_index, layout.model_index),
        "head": (tuple(head.weight.shape), tuple(head.bias.shape)),
        "trace": tuple(state.optimizer.slots["trace"][-2].shape)}


def _recut_equal(layout, state, seen, out_dir):
    """Rank 0 saves the gathered last state with `CheckpointManager`; every
    rank restores it and cuts it again under `layout`: whether the cut
    equals its live slices bitwise."""
    from geoestimation_tpu_torch.checkpoint import CheckpointManager, cut

    last, sharded = seen["after"][-1], seen["sharded"]
    ckpt = CheckpointManager(os.path.join(out_dir, "ckpt"))
    names = [k for k, _ in state.model.named_parameters()]
    ckpt.save(len(seen["after"]), {
        "model": last["model"],
        "optimizer": {"count": state.optimizer.count, "slots": {
            "trace": list(last["trace"].values())}},
        "step": len(seen["after"])})
    restored = ckpt.restore()
    sd = cut(restored["model"], sharded, layout)
    slots = cut(dict(zip(names, restored["optimizer"]["slots"]["trace"])),
                sharded, layout)
    live = state.model.state_dict()
    return all(torch.equal(sd[k], live[k]) for k in live) and all(
        torch.equal(slots[k], t)
        for k, t in zip(names, state.optimizer.slots["trace"]))


def peer_grads(rank, world, out_dir, shape):
    """`all_reduce_grads` at mesh `shape` (n_data, n_model[, dcn_data]) on
    a replicated parameter and a head slice (marked `model_split`) whose
    gradients differ on every rank, as backwards that disagree in the last
    bit would: the gradients after it and the rank's coordinates."""
    from geoestimation_tpu_torch.parallel import mesh, multihost

    layout = mesh.make_mesh(*shape[:2], dcn_data=(*shape, 1)[2])
    rep, head = torch.nn.Parameter(torch.zeros(5)), \
        torch.nn.Parameter(torch.zeros(3))
    head.model_split = True
    rep.grad = torch.arange(5.0) + 10.0 * rank
    head.grad = torch.arange(3.0) + 100.0 * rank
    with layout.active():
        multihost.all_reduce_grads([rep, head])
    torch.save({"rep": rep.grad, "head": head.grad,
                "coords": (layout.data_index, layout.model_index)},
               os.path.join(out_dir, f"peer_grads{rank}.pt"))


def mesh_fit(rank, world, out_dir, config_path, mesh_shape):
    """Trainer.fit for 2 steps at `mesh_shape` from the seed, its
    checkpoint under out_dir/ckpt; then a second Trainer at the same mesh
    resumes from it: whether its placed state equals the fit's bitwise."""
    from geoestimation_tpu_torch.train import loop
    from geoestimation_tpu_torch.utils.config import load_config

    config = load_config(config_path)
    config.train_params.checkpoint_dir = os.path.join(out_dir, "ckpt")
    config.train_params.mesh_shape = list(mesh_shape)
    lines = []
    trainer = loop.Trainer(config, log_fn=lines.append, device="cpu")
    state = trainer.fit(max_steps=2, resume=False)
    again = loop.Trainer(config, log_fn=lines.append, device="cpu")
    resumed = again.maybe_resume(again.initial_state(10))
    live, back = state.model.state_dict(), resumed.model.state_dict()
    slots = zip(state.optimizer.slots["trace"],
                resumed.optimizer.slots["trace"])
    torch.save({"step": resumed.step, "log": lines,
                "head": tuple(state.model.heads.fused_head.weight.shape),
                "resumed_equal": all(torch.equal(live[k], back[k])
                                     for k in live)
                and all(torch.equal(a, b) for a, b in slots)},
               os.path.join(out_dir, f"fit{rank}.pt"))

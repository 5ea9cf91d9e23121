"""Rank bodies of the port's multi-process CPU tests.

`start` starts `world` processes (torch.multiprocessing, spawn), each of
which joins a gloo group on the CPU with a 30 s collective timeout, pins
torch to one thread, fails the TensorBoard import (it would import
TensorFlow) and runs one of the bodies below, which write what they saw
under `out_dir`. This module imports no JAX, so the ranks start quickly.
"""

import os
import socket
import sys
import time
import traceback

import numpy as np
import torch

N_CLASSES = (3, 5, 9)
ARCH = "resnet14"
TIMEOUT_S = 30


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _main(fn, rank, world, port, out_dir, args):
    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None
    from geoestimation_tpu_torch.parallel import multihost

    try:
        multihost.initialize(f"127.0.0.1:{port}", world, rank, cpu=True,
                             timeout_s=TIMEOUT_S)
        fn(rank, world, out_dir, *args)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        multihost.shutdown()


def start(fn, out_dir, *args, world=2):
    """Start fn(rank, world, out_dir, *args) in `world` ranks."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_main,
                         args=(fn, r, world, port, str(out_dir), args))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, str(out_dir)


def join(started, timeout=120):
    """Wait for `start`'s ranks; kill them all at `timeout` s; raise with
    the tracebacks if a rank failed."""
    procs, out_dir = started
    deadline = time.time() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.time()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = []
    for r, p in enumerate(procs):
        path = os.path.join(out_dir, f"rank{r}.err")
        if p.exitcode != 0:
            errors.append(f"rank {r} exit {p.exitcode}:\n"
                          + (open(path).read() if os.path.exists(path)
                             else "(no traceback: killed at the timeout)"))
    if errors:
        raise AssertionError("\n".join(errors))


def spawn(fn, out_dir, *args, world=2, timeout=120):
    join(start(fn, out_dir, *args, world=world), timeout)


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

def seeded_state(remat=False, n_scenes=None):
    """The seeded float32 weights of tests/test_torch_port_train.py's
    `_states`, as the port's TrainState (SGD lr 0.05, momentum 0.9, weight
    decay 1e-4, constant schedule)."""
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
    params, stats = world.seeded_jax_variables(rng, ARCH, N_CLASSES,
                                               n_scenes)
    if n_scenes:
        model = ISNClassifier(N_CLASSES, n_scenes, ARCH, torch.float32,
                              remat=remat)
    else:
        model = classifier.MultiPartitioningClassifier(
            N_CLASSES, ARCH, torch.float32, remat=remat)
    model.load_state_dict(from_jax_variables(params, stats, ARCH, N_CLASSES))
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

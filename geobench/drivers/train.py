"""The training loop of the baseM recipe on one card: the port's train step
(`train/step.py` as `Trainer._train_fn` calls it, under the trainer's
layout) on batches that `ShardBatcher` decoded in set-up from a seeded
msgpack shard world, held in host memory and cycled, the augmentation on
the device. `train_images_per_s` is the images of the window's optimizer
steps over the window's seconds.

Set-up writes the world into a temporary directory under `TMPDIR` (JPEGs
made on the device from the seed and encoded by Pillow, each record's
coordinates the center of a fine cell drawn from the seed, the
partitionings as cell CSVs), draws the mix's `held_batches` from the
loader and stops it, builds the trainer's state with the benchmark's
seeded weights, and drives it through its first steps with the window's
own call and feed: the first three are followed by the float32 reference
once the window has closed (each step's loss, the first gradient as the
optimizer got it, the parameters' change over the three), the rest warm
up. The window then goes on with the same state and feed. No loader
thread runs in it: decode threads in the step's process take the
interpreter from the thread that launches the step's kernels, and the
rate then follows the load of the host's shared cores. The traced run
profiles a few seconds of the same loop after the window."""

from __future__ import annotations

import contextlib
import gc
import itertools
import os
import sys
import tempfile
import time

import numpy as np

from .. import harness
from .common import TRACE_SECONDS, Outcome, Phases, free, peak_bytes, sync

CHECKED_STEPS = 3


def write_world(root, traffic, parts, seed, device):
    """The seeded shard world under `root`: {"shards": glob, "csvs":
    [path], "blobs": [JPEG bytes], "fine": (n,) fine class of each
    record}. Record i has the i-th of the mix's sizes and qualities; its
    content and cell depend on `seed`."""
    import msgpack

    n, sizes, qual = traffic["records"], traffic["sizes"], traffic["quality"]
    rng = np.random.default_rng([seed, 4])
    fine = rng.integers(len(parts[-1][1]), size=n)
    blobs = [None] * n
    for k, (w, h) in enumerate(sizes):
        idx = np.arange(k, n, len(sizes))
        sub = np.random.SeedSequence([seed, 5, k]).generate_state(
            2, np.uint32)
        photos = harness.make_photos(len(idx), (h, w),
                                     int(sub[0]) << 31 | int(sub[1]), device)
        q = [qual[0] + i % (qual[1] - qual[0] + 1) for i in idx]
        for i, blob in zip(idx, harness.encode_jpegs(photos, q)):
            blobs[i] = blob
    _, _, flat, flng = parts[-1]
    packer = msgpack.Packer(use_bin_type=True)
    for j in range(traffic["shards"]):
        with open(os.path.join(root, f"world-{j:03d}.msgpack"), "wb") as f:
            for i in range(j, n, traffic["shards"]):
                f.write(packer.pack({"id": str(i), "image": blobs[i],
                                     "lat": float(flat[fine[i]]),
                                     "lng": float(flng[fine[i]])}))
    csvs = []
    for name, tokens, lat, lng in parts:
        path = os.path.join(root, f"cells_{name}.csv")
        with open(path, "w") as f:
            f.write("class_label,hex_id,imgs_per_cell,latitude_mean,"
                    "longitude_mean\n")
            for c, (t, a, b) in enumerate(zip(tokens, lat, lng)):
                f.write(f"{c},{t},1,{float(a)!r},{float(b)!r}\n")
        csvs.append(path)
    return {"shards": os.path.join(root, "world-*.msgpack"), "csvs": csvs,
            "blobs": blobs, "fine": fine}


def port_config(cell, world, seed, root):
    """The port's `Config` of the recipe over the world."""
    from geoestimation_tpu_torch.utils.config import Config

    cfg, recipe = cell["config"], cell["recipe"]
    config = Config()
    mp, tp = config.model_params, config.train_params
    mp.arch, mp.dtype = cfg["arch"], recipe["dtype"]
    mp.partitionings.files = tuple(world["csvs"])
    mp.partitionings.shortnames = tuple(cfg["partitionings"])
    tp.batch_size = recipe["batch_size"]
    opt = tp.optimizer
    opt.name, opt.lr, opt.momentum = "sgd", recipe["lr"], recipe["momentum"]
    opt.weight_decay, opt.nesterov = recipe["weight_decay"], False
    sched = tp.lr_schedule
    sched.name, sched.milestones = "multistep", tuple(recipe["milestones"])
    sched.gamma, sched.warmup_epochs = recipe["gamma"], recipe["warmup_epochs"]
    tp.train_shards = (world["shards"],)
    tp.num_workers = recipe["num_workers"]
    tp.label_smoothing = 0.0
    tp.seed = seed
    tp.image_size = recipe["image_size"]
    tp.train_crop_scale = tuple(recipe["crop_scale"])
    tp.checkpoint_dir = os.path.join(root, "checkpoints")
    return config


def build_state(trainer, config, sd, steps_per_epoch):
    """`Trainer.initial_state` with the benchmark's weights in place of the
    trainer's own initializers (the module built on the meta device, so
    nothing is drawn that is thrown away)."""
    import torch

    from geoestimation_tpu_torch.train.init import model_from_config
    from geoestimation_tpu_torch.train.optim import build_optimizer
    from geoestimation_tpu_torch.train.step import TrainState

    with torch.device("meta"):
        model = model_from_config(config, trainer.n_classes)
    model = model.to_empty(device=trainer.device)
    model.load_state_dict(sd)
    model = model.to(memory_format=torch.channels_last)
    tp = trainer.tp
    optimizer = build_optimizer(model.parameters(), tp.optimizer,
                                tp.lr_schedule, steps_per_epoch)
    trainer.schedule = optimizer.schedule
    return trainer.place(TrainState(model, optimizer))


def reference_batches(world, parts, ids_list, device):
    """The checked steps' inputs as the reference makes them: each row's
    JPEG decoded by the reference, its labels the fine cell the benchmark
    drew and that cell's ancestors."""
    import torch

    from ..reference import decode, geo

    maps, _ = geo.ancestor_maps(parts)
    out = []
    for ids in ids_list:
        rows = np.array([int(i) for i in ids])
        images = np.stack([decode.decode(world["blobs"][r]) for r in rows])
        fine = world["fine"][rows]
        labels = np.stack([m[fine] for m in maps])
        out.append((torch.as_tensor(images, device=device),
                    torch.as_tensor(labels, dtype=torch.int64,
                                    device=device)))
    return out


@contextlib.contextmanager
def no_tensorboard():
    """The trainer's metrics logger mirrors to TensorBoard where it
    imports; its import loads TensorFlow (and with it, where installed,
    JAX) into the process. The window logs nothing, so the import is made
    to fail while the trainer is built, and the logger writes its CSV
    alone."""
    name = "torch.utils.tensorboard"
    saved = sys.modules.get(name, False)
    sys.modules[name] = None
    try:
        yield
    finally:
        if saved is False:
            del sys.modules[name]
        else:
            sys.modules[name] = saved


def _host(t):
    """A float32 copy of `t` on the host (a copy on the CPU too)."""
    import torch

    return t.detach().to("cpu", torch.float32, copy=True)


def run(ctx):
    from geoestimation_tpu_torch.data.loader import ShardBatcher
    from geoestimation_tpu_torch.train.loop import Trainer

    cell, device, seed = ctx.cell, ctx.device, ctx.seed
    cfg, traffic, recipe = cell["config"], cell["traffic"], cell["recipe"]
    batch = recipe["batch_size"]
    phases = Phases(ctx.t0)
    phases.mark("imports")
    tmp = tempfile.TemporaryDirectory(prefix="geobench-world-")
    try:
        sd = harness.make_state_dict(cfg, seed, device)
        parts = harness.make_partitionings(cfg, seed)
        world = write_world(tmp.name, traffic, parts, seed, device)
        phases.mark("inputs")
        config = port_config(cell, world, seed, tmp.name)
        with no_tensorboard():
            trainer = Trainer(config, log_fn=lambda *_: None, device=device)
        steps_per_epoch = traffic["records"] // batch
        state = build_state(trainer, config, sd, steps_per_epoch)
        del sd
        batcher = iter(ShardBatcher(
            config.train_params.train_shards, batch_size=batch,
            partitionings=trainer.partitionings, shuffle=True, seed=seed,
            repeat=True, num_workers=recipe["num_workers"]))
        start = time.perf_counter()
        held = [next(batcher) for _ in range(traffic["held_batches"])]
        loader_s = time.perf_counter() - start
        loader_images = sum(len(b.ids) for b in held)
        batcher.close()
        feed = itertools.cycle(held)
        train_fn = trainer._train_fn()
        names = [k for k, _ in state.model.named_parameters()]
        phases.mark("trainer")

        with trainer.layout.active():
            def step():
                nonlocal state
                b = next(feed)
                state, metrics = train_fn(state, b)
                return b, metrics

            checked = {"ids": [], "losses": []}
            for k in range(CHECKED_STEPS):
                b, metrics = step()
                checked["ids"].append(list(b.ids))
                checked["losses"].append(float(metrics["loss"]))
                if k == 0:
                    checked["trace1"] = {
                        n: _host(t) for n, t in
                        zip(names, state.optimizer.slots["trace"])}
            checked["params"] = {n: _host(p) for n, p in
                                 state.model.named_parameters()}
            for _ in range(traffic["warmup_steps"]):
                step()
            sync(device)
            phases.mark("checked and warm-up steps")
            phases.report()
            setup_s = time.perf_counter() - ctx.t0

            steps = 0
            start = time.perf_counter()
            while time.perf_counter() - start < ctx.seconds:
                step()
                steps += 1
            sync(device)
            window_s = time.perf_counter() - start
            peak = peak_bytes(device)

            trace = None
            if ctx.trace and device.type == "cuda":
                from ..trace import trace_loop

                trace = trace_loop(step, TRACE_SECONDS, lambda: sync(device))
        del state, feed, held, batcher, trainer, train_fn
        gc.collect()
        free(device)

        readings = judge(cell, seed, world, parts, checked, device)
        images_per_s = steps * batch / window_s
        return Outcome(
            attempted=steps * batch, failed=0,
            end_to_end={"train_images_per_s": images_per_s,
                        "setup_s": setup_s},
            compared=[(name, readings[name], limit)
                      for name, limit in cell["limits"].items()],
            readings=readings, memory_peak_bytes=peak, trace=trace,
            counters={"train_images_per_s": images_per_s, "steps": steps,
                      "window_s": window_s,
                      "loader_images": loader_images,
                      "loader_s": loader_s},
            sample=(world, parts, checked))
    finally:
        tmp.cleanup()


def reference_steps(cell, seed, world, parts, ids, device, quant=None,
                    rows=None):
    """The float32 reference (rounded by `quant`, or on the first `rows`
    of each batch, where given) over the steps whose rows are `ids`."""
    from ..reference import train as ref

    cfg, traffic, recipe = cell["config"], cell["traffic"], cell["recipe"]
    sd = harness.make_state_dict(cfg, seed, device)
    out = ref.steps(sd, reference_batches(world, parts, ids, device),
                    cfg["arch"], [len(p[1]) for p in parts], recipe,
                    traffic["records"] // recipe["batch_size"], seed,
                    quant=quant, rows=rows)
    return out, sd


def judge(cell, seed, world, parts, checked, device):
    """The readings of the checked steps against the float32 reference:
    the readings of `reference.train.judge`."""
    from ..reference import train as ref

    reference, sd = reference_steps(cell, seed, world, parts,
                                    checked["ids"], device)
    return ref.judge(checked, reference, sd,
                     cell["recipe"]["weight_decay"])


KINDS = ("precision", "half_batch")


def control(ctx, out, kind):
    """The readings of the reference put in the program's place on the
    run's own steps: `kind` "precision" (fp8 training, below the recipe's
    bf16: `reference.quant.fp8_training`) or "half_batch" (each step on
    the first half of its rows, the mean taken over them)."""
    from ..reference import train as ref
    from ..reference.quant import TRAINING_CONTROLS

    cell, seed, device = ctx.cell, ctx.seed, ctx.device
    world, parts, checked = out.sample
    half = cell["recipe"]["batch_size"] // 2
    placed, _ = reference_steps(
        cell, seed, world, parts, checked["ids"], device,
        quant=(TRAINING_CONTROLS[cell["precision"]] if kind == "precision"
               else None),
        rows=half if kind == "half_batch" else None)
    wd = cell["recipe"]["weight_decay"]
    sd = harness.make_state_dict(cell["config"], seed, device)
    first = {k: g + wd * sd[k].detach().cpu()
             for k, g in placed["grad0"].items()}
    as_program = {"losses": placed["losses"], "trace1": first,
                  "params": placed["params"]}
    reference, _ = reference_steps(cell, seed, world, parts, checked["ids"],
                                   device)
    return ref.judge(as_program, reference, sd, wd)

"""Training loop: epochs, logging, validation, checkpointing.

The port of `geoestimation_tpu/train/loop.py`: the step on the device for
each batch of the loader, validation at intervals (val_loss and the GCD
accuracies of the f* rule), best-val-loss checkpoint retention, resume from
the latest checkpoint, a checkpoint on SIGTERM, and an optional
`torch.profiler` trace (`profile_dir`), which carries the port's spans
(`utils/spans.py`: `train.step` and its stages, `train.batch_wait`).

In several processes (`parallel/multihost.py`) every process runs this same
Trainer on its device, one slot of the (data, model) layout each
(`train_params.mesh_shape` [n_data, n_model], default every rank on the
data axis): `data_feed: lockstep` slices identical global batches by data
index (`LockstepSlicer`), `strided` reads a shard subset per data index
(`StridedFeed`); validation stays lockstep and its sums are merged over the
ranks, model-axis peers counted once; process 0 logs and writes
checkpoints. With n_model > 1 the fused head and its momentum are cut to
each rank's slice (`place`, the JAX loop's), and a checkpoint holds them
whole, gathered over the model group, so it reads as a one-axis run's and
resumes under any layout. The JAX loop acts on each process's own SIGTERM
flag; this one agrees the flag over the ranks once a step, so every rank
checkpoints at the same step.
"""

from __future__ import annotations

import functools
import os
import signal
import time
from typing import Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager, cut, whole
from ..data.loader import ShardBatcher, load_label_csv
from ..data.shards import count_records, expand_shard_patterns
from ..eval.engine import resolve_device, resolve_partitioning_paths
from ..eval.infer import HierarchyArrays, predict_hierarchical
from ..eval.metrics import GcdAccumulator, gcd_threshold_counts
from ..geo import Hierarchy, load_partitionings
from ..parallel import multihost
from ..parallel.mesh import make_mesh
from ..utils.logging import MetricsLogger
from ..utils.spans import span
from .init import init_weights, model_from_config
from .optim import build_optimizer
from .step import (
    TrainState,
    eval_step,
    eval_step_isn,
    train_step,
    train_step_isn,
)


def _on_layout(method):
    """Run a Trainer method with its layout's process groups active
    (`MeshLayout.active`): its collectives sum over the layout's axes, and
    no other code in the process inherits them."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with self.layout.active():
            return method(self, *args, **kwargs)
    return run


class Trainer:
    def __init__(self, config, search_dirs=(), log_fn=print, device="cuda"):
        self.config = config
        self.tp = tp = config.train_params
        if tp.data_feed not in ("lockstep", "strided"):
            raise ValueError(
                f"unknown train_params.data_feed {tp.data_feed!r}; "
                "expected 'lockstep' or 'strided'")
        # every process runs this same Trainer; process 0 logs and writes
        self.n_procs = multihost.process_count()
        self.proc_id = multihost.process_index()
        self.log = log_fn if self.proc_id == 0 else (lambda *_: None)
        self.device = resolve_device(device)
        # mesh_shape over the ranks in order, one device each (None = all
        # on the data axis); in one process, this device
        self.layout = make_mesh(
            *(tp.mesh_shape or (None,)),
            devices=None if self.n_procs > 1 else [self.device])
        self.data_index = self.layout.data_index
        self.n_data = self.layout.n_data if self.n_procs > 1 else 1
        self.sharded = {}         # parameter name -> the model axis's dim
        paths = resolve_partitioning_paths(
            config.model_params.partitionings.files, list(search_dirs))
        self.partitionings = load_partitionings(
            paths, names=list(config.model_params.partitionings.shortnames))
        self.harrays = HierarchyArrays.from_hierarchy(
            Hierarchy.build(self.partitionings), self.device)
        self.n_classes = tuple(len(p) for p in self.partitionings)
        # Without validation data every checkpoint is metric-less and
        # best-val-loss retention would keep all of them forever; keep the
        # latest N in that case.
        self.ckpt = CheckpointManager(
            tp.checkpoint_dir, max_to_keep=tp.keep_checkpoints,
            best_metric="val_loss" if tp.val_shards else None)
        # process 0 only: N processes appending to one metrics.csv would
        # interleave rows
        self.metrics = (MetricsLogger(tp.checkpoint_dir,
                                      stdout=lambda s: None)
                        if self.proc_id == 0 else None)
        self.batch_wait_s = 0.0   # host time spent waiting for train batches

    # -- state --------------------------------------------------------------

    @_on_layout
    def initial_state(self, steps_per_epoch: int) -> TrainState:
        model = init_weights(model_from_config(self.config, self.n_classes),
                             self.tp.seed)
        if self.layout.n_model > 1 and hasattr(model, "shard_"):
            # the whole head's placement, then its slice (ISN's heads stay
            # replicated, as the JAX package's mesh leaves them)
            self.sharded = {
                k: d for k, d in self.layout.params(
                    dict(model.named_parameters())).items() if d is not None}
            model.shard_(self.layout)
        model = model.to(self.device, memory_format=torch.channels_last)
        optimizer = build_optimizer(model.parameters(), self.tp.optimizer,
                                    self.tp.lr_schedule, steps_per_epoch)
        self.schedule = optimizer.schedule
        return self.place(TrainState(model, optimizer))

    def _slot_names(self, state):
        return [k for k, _ in state.model.named_parameters()]

    @_on_layout
    def place(self, state: TrainState) -> TrainState:
        """Rank 0's parameters, statistics and optimizer slots on every
        rank, a head slice and its momentum from the first rank of its
        data group (the JAX loop's `place`; no-op in one process)."""
        sharded = [t for k, t in state.model.state_dict().items()
                   if k in self.sharded]
        replicated = [t for k, t in state.model.state_dict().items()
                      if k not in self.sharded]
        for slot in state.optimizer.slots.values():
            for k, t in zip(self._slot_names(state), slot):
                (sharded if k in self.sharded else replicated).append(t)
        multihost.broadcast_tensors(replicated, sharded)
        return state

    @_on_layout
    def whole_state(self, state: TrainState) -> dict:
        """{model, optimizer, step} with the head and its slots gathered
        whole over the model group: a one-axis run's layout. Collective:
        every rank calls it."""
        opt = state.optimizer.state_dict()
        names = self._slot_names(state)
        return {
            "model": whole(state.model.state_dict(), self.sharded),
            "optimizer": {**opt, "slots": {
                k: list(whole(dict(zip(names, ts)), self.sharded).values())
                for k, ts in opt["slots"].items()}},
            "step": state.step}

    @_on_layout
    def maybe_resume(self, state: TrainState) -> TrainState:
        # every rank restores the step process 0 sees as the latest
        latest = multihost.broadcast_object(self.ckpt.latest_step())
        if latest is None:
            return state
        self.log(f"resuming from step {latest}")
        restored = self.ckpt.restore(latest)
        names = self._slot_names(state)
        opt = restored["optimizer"]
        opt["slots"] = {
            k: list(cut(dict(zip(names, ts)), self.sharded,
                        self.layout).values())
            for k, ts in opt["slots"].items()}
        state.model.load_state_dict(cut(restored["model"], self.sharded,
                                        self.layout))
        state.optimizer.load_state_dict(opt)
        state.step = int(restored["step"])
        return self.place(state)

    # -- data ---------------------------------------------------------------

    def _batcher(self, patterns, labels_csv, shuffle, seed):
        label_map = scene_map = None
        if labels_csv:
            label_map, scene_map = load_label_csv(
                labels_csv,
                self.config.model_params.partitionings.shortnames,
                with_scene=True,
            )
        common = dict(
            partitionings=None if label_map else self.partitionings,
            label_map=label_map,
            scene_map=scene_map,
            shuffle=shuffle,
            seed=seed,
            repeat=False,
            num_workers=self.tp.num_workers,
            # validation (shuffle=False) must not double-count tile-padded
            # duplicates in val_loss / GCD accuracy
            mask_padding=not shuffle,
        )
        # a data index's rows: model-axis peers read the same ones
        n, p = self.n_data, self.data_index
        if n > 1 and self.tp.data_feed == "strided" and shuffle:
            # strided (training feed only): each data index reads
            # shards[p::n] and decodes only its rows; StridedFeed agrees the
            # batch counts over every rank so uneven shard subsets cannot
            # leave a rank in a collective.
            # Validation stays lockstep: its metrics must match one
            # process's, and a val set may have fewer shards than ranks.
            if self.tp.batch_size % n:
                raise ValueError(f"global batch {self.tp.batch_size} not "
                                 f"divisible by {n} processes")
            # checked here, not at the first batch: every process sees the
            # same shard list, so all raise together BEFORE any collective
            n_shards = len(expand_shard_patterns(patterns))
            if n_shards < n:
                raise ValueError(
                    f"data_feed: strided needs >= 1 shard per process "
                    f"({n_shards} shards, {n} processes); re-shard the data "
                    "or use data_feed: lockstep")
            return multihost.StridedFeed(ShardBatcher(
                patterns, batch_size=self.tp.batch_size // n, host_id=p,
                host_count=n, **common))
        # lockstep (default): every process materializes IDENTICAL global
        # batches (same shards, same seed) and keeps its slice
        batcher = ShardBatcher(patterns, batch_size=self.tp.batch_size,
                               **common)
        if self.n_procs > 1:
            return multihost.LockstepSlicer(batcher, p, n)
        return batcher

    def _feed(self, arr):
        return torch.as_tensor(arr).to(self.device, non_blocking=True)

    def _timed(self, batcher):
        """The batches of `batcher`, adding the host's wait for each to
        `batch_wait_s`."""
        it = iter(batcher)
        while True:
            t0 = time.perf_counter()
            with span("train.batch_wait"):
                batch = next(it, None)
            self.batch_wait_s += time.perf_counter() - t0
            if batch is None:
                return
            yield batch

    def _scene(self, batch):
        scene = batch.scene if batch.scene is not None \
            else np.full(batch.images.shape[0], -1, np.int32)
        return self._feed(scene)

    # -- validation ---------------------------------------------------------

    @_on_layout
    def validate(self, state: TrainState) -> dict:
        batcher = self._batcher(self.tp.val_shards, self.tp.val_labels,
                                shuffle=False, seed=0)
        isn = self.config.model_params.scene_gating
        crop = self.tp.image_size
        losses = []
        scene_correct = scene_total = 0
        gcd = GcdAccumulator()
        for batch in batcher:
            images, labels = self._feed(batch.images), self._feed(batch.labels)
            if isn:
                metrics, logits = eval_step_isn(state, images, labels,
                                                self._scene(batch), crop)
                scene_correct += int(metrics["scene_correct"])
                scene_total += int(metrics["scene_total"])
            else:
                metrics, logits = eval_step(state, images, labels, crop)
            # in several processes, this rank's share of the batch's loss
            losses.append(float(metrics["val_loss"]))
            if batch.latlng is not None:
                known = ~np.isnan(batch.latlng[:, 0])
                if known.any():
                    _, plat, plng = predict_hierarchical(list(logits),
                                                         self.harrays)
                    counts, total = gcd_threshold_counts(
                        plat, plng, self._feed(batch.latlng[:, 0]),
                        self._feed(batch.latlng[:, 1]),
                        valid=self._feed(known))
                    gcd.update(counts, total)
        if self.n_procs > 1:
            # every rank joins, one without known coordinates too; a data
            # index counts once, from its model index 0
            if self.layout.model_index:
                losses = [0.0] * len(losses)
                scene_correct = scene_total = 0
                gcd = GcdAccumulator()
            summed = multihost.host_sum(np.array(
                losses + [scene_correct, scene_total], np.float64))
            losses = list(summed[:-2])
            scene_correct, scene_total = int(summed[-2]), int(summed[-1])
            multihost.merge_gcd_accumulators({"gcd": gcd})
        out = {"val_loss": float(np.mean(losses)) if losses else float("nan")}
        if scene_total:
            out["scene_acc"] = scene_correct / scene_total
        if gcd.total:
            out.update({f"gcd@{int(k)}km": v for k, v in gcd.result().items()})
        return out

    # -- main loop ----------------------------------------------------------

    def _train_fn(self):
        tp = self.tp
        kw = dict(label_smoothing=tp.label_smoothing, crop=tp.image_size,
                  crop_scale=tuple(tp.train_crop_scale)
                  if tp.train_crop_scale else None)
        isn = self.config.model_params.scene_gating

        def train_fn(state, batch):
            with span("train.step", request=state.step):
                images = self._feed(batch.images)
                labels = self._feed(batch.labels)
                if isn:
                    return train_step_isn(
                        state, images, labels, self._scene(batch), tp.seed,
                        scene_loss_weight=tp.scene_loss_weight, **kw)
                return train_step(state, images, labels, tp.seed, **kw)

        return train_fn

    @_on_layout
    def fit(self, max_steps: Optional[int] = None, resume: bool = True):
        tp = self.tp
        steps_per_epoch = tp.steps_per_epoch
        if steps_per_epoch is None:
            n = count_records(tp.train_shards)
            steps_per_epoch = max(1, n // tp.batch_size)
            self.log(f"{n} training records -> {steps_per_epoch} steps/epoch")
        total_steps = max_steps or steps_per_epoch * tp.epochs

        state = self.initial_state(steps_per_epoch)
        if resume:
            state = self.maybe_resume(state)
        step = state.step
        train_fn = self._train_fn()

        profiler = None
        if tp.profile_dir:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()
        t0 = time.time()
        images_seen = 0

        # Preemption safety: checkpoint on SIGTERM so a maintenance event or
        # scheduler kill resumes cleanly.
        self._interrupted = False

        def _on_sigterm(signum, frame):
            self._interrupted = True
            self.log("SIGTERM received; checkpointing at next step")

        old_handler = None
        try:
            old_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            pass  # not the main thread (tests)
        try:
            while step < total_steps:
                epoch_start_step = step
                batcher = self._batcher(
                    tp.train_shards, tp.train_labels, shuffle=True,
                    seed=tp.seed + step,
                )
                for batch in self._timed(batcher):
                    state, metrics = train_fn(state, batch)
                    step = state.step
                    images_seen += batch.images.shape[0] * self.n_data
                    if step % tp.log_every_steps == 0 or step == total_steps:
                        loss = float(metrics["loss"])
                        dt = time.time() - t0
                        ips = images_seen / dt if dt > 0 else 0
                        lr = float(self.schedule(step))
                        self.log(
                            f"step {step}/{total_steps} loss {loss:.4f} "
                            f"lr {lr:.5f} {ips:.1f} img/s"
                        )
                        self._log_metrics(step, {"loss": loss, "lr": lr,
                                                 "images_per_sec": ips},
                                          "train/")
                    do_ckpt = (tp.checkpoint_every_steps and
                               step % tp.checkpoint_every_steps == 0)
                    do_val = (tp.val_every_steps and
                              step % tp.val_every_steps == 0)
                    if do_ckpt:
                        # _checkpoint runs (and logs) validation itself, so
                        # a coinciding val_every_steps boundary must not run
                        # the full val set a second time
                        self._checkpoint(state, step)
                    elif do_val:
                        self.log(f"val @ {step}: {self.validate(state)}")
                    # one flag for all ranks, so all checkpoint at this step
                    if multihost.host_any(self._interrupted):
                        self._checkpoint(state, step, val_metrics={})
                        self.log(f"checkpointed at step {step} after "
                                 "SIGTERM; exiting")
                        return state
                    if step >= total_steps:
                        break
                else:
                    if step == epoch_start_step:
                        # zero batches produced: every record was dropped
                        # (e.g. label CSV ids don't match the shards) --
                        # fail loudly instead of spinning forever.
                        raise RuntimeError(
                            "training epoch produced no batches -- check "
                            "that the label CSV IMG_IDs match the shard "
                            "record ids and that shards decode"
                        )
                    # epoch boundary: validate + checkpoint
                    val = self.validate(state) if tp.val_shards else {}
                    if val:
                        self.log(f"epoch end @ {step}: {val}")
                    self._checkpoint(state, step, val_metrics=val)
        finally:
            if profiler is not None:
                profiler.stop()
                os.makedirs(tp.profile_dir, exist_ok=True)
                name = ("trace.json" if self.proc_id == 0
                        else f"trace.rank{self.proc_id}.json")
                profiler.export_chrome_trace(
                    os.path.join(tp.profile_dir, name))
            if old_handler is not None:
                try:
                    signal.signal(signal.SIGTERM, old_handler)
                except ValueError:
                    pass
        self._checkpoint(state, step)
        return state

    def _checkpoint(self, state, step, val_metrics=None):
        if val_metrics is None:
            val_metrics = self.validate(state) if self.tp.val_shards else {}
            if val_metrics:
                self.log(f"val @ {step}: {val_metrics}")
        if val_metrics:
            self._log_metrics(step, val_metrics, "val/")
        # metric-less saves (no validation ran) are exempt from best-N
        # cleanup -- see CheckpointManager.save
        metrics = (
            {"val_loss": val_metrics["val_loss"]}
            if "val_loss" in val_metrics else None
        )
        self.ckpt.save(step, self.whole_state(state), metrics=metrics,
                       config=self.config)

    def _log_metrics(self, step, metrics, prefix):
        if self.metrics is not None:
            self.metrics.log(step, metrics, prefix=prefix)

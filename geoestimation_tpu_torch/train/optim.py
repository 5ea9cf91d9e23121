"""Optimizers and learning-rate schedules, with optax's semantics.

The port of `geoestimation_tpu/train/optim.py`. A schedule is a plain
function of the update count (`lr(count)`), evaluated once per step: the
count starts at 0 and advances after each update, as optax's
`scale_by_learning_rate` counts. The optimizers compute the optax chains the
JAX package builds, on the parameters in place:

  * SGD: `add_decayed_weights(wd)` on every parameter (u = g + wd * p),
    then the momentum trace t = u + momentum * t (the first trace is u;
    with nesterov the update is u + momentum * t), then p -= lr * update,
    over all the leaves at once;
  * AdamW: `scale_by_adam` (bias-corrected moments, eps outside the root),
    then `add_decayed_weights`, then p -= lr * update.
"""

from __future__ import annotations

import bisect
import math

import numpy as np
import torch


def multistep_schedule(base_lr: float, milestones, gamma: float,
                       steps_per_epoch: int, warmup_epochs: float = 0.0):
    """lr(count): base_lr times gamma for each milestone (in epochs) whose
    step the count has reached; with warmup, a linear ramp from 0 over the
    warmup steps, the milestones then counted from its end (optax's
    `join_schedules`). Raises ValueError for a milestone inside the
    warmup."""
    boundaries = sorted({int(m * steps_per_epoch) for m in milestones})
    warmup_steps = 0
    if warmup_epochs > 0:
        warmup_steps = max(1, int(warmup_epochs * steps_per_epoch))
        inside = [k for k in boundaries if k <= warmup_steps]
        if inside:
            raise ValueError(
                f"lr milestones at steps {sorted(inside)} fall inside the "
                f"{warmup_steps}-step warmup; use milestones > "
                f"warmup_epochs ({warmup_epochs})"
            )
        boundaries = [k - warmup_steps for k in boundaries]

    def piecewise(count):
        return base_lr * gamma ** bisect.bisect_right(boundaries, count)

    if not warmup_steps:
        return piecewise

    def schedule(count):
        if count < warmup_steps:
            return base_lr * count / warmup_steps
        return piecewise(count - warmup_steps)

    return schedule


def cosine_schedule(base_lr: float, decay_steps: int):
    """optax.cosine_decay_schedule(base_lr, decay_steps) with alpha 0."""
    def schedule(count):
        frac = min(count, decay_steps) / decay_steps
        return base_lr * 0.5 * (1 + math.cos(math.pi * frac))

    return schedule


def constant_schedule(base_lr: float):
    return lambda count: base_lr


class Optimizer:
    """SGD with momentum (optionally nesterov) or AdamW over a list of
    parameters, updated in place by `step()` from their `.grad`."""

    def __init__(self, params, schedule, name="sgd", momentum=0.9,
                 nesterov=False, weight_decay=0.0, b1=0.9, b2=0.999,
                 eps=1e-8):
        if name not in ("sgd", "adamw"):
            raise ValueError(f"unknown optimizer {name!r}")
        self.params = list(params)
        self.schedule = schedule
        self.name = name
        self.momentum, self.nesterov = momentum, nesterov
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        zeros = [torch.zeros_like(p) for p in self.params]
        if name == "sgd":
            self.slots = {"trace": zeros}
        else:
            self.slots = {"mu": zeros,
                          "nu": [torch.zeros_like(p) for p in self.params]}

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        lr = self.schedule(self.count)
        if self.name == "sgd":
            self._sgd(lr)
        else:
            # the bias corrections in float32, as optax computes them
            n = np.float32(self.count + 1)
            c1 = float(1 - np.float32(self.b1) ** n)
            c2 = float(1 - np.float32(self.b2) ** n)
            for p, mu, nu in zip(self.params, self.slots["mu"],
                                 self.slots["nu"]):
                g = p.grad
                mu.mul_(self.b1).add_((1 - self.b1) * g)
                nu.mul_(self.b2).add_((1 - self.b2) * g.square())
                u = (mu / c1) / ((nu / c2).sqrt() + self.eps)
                if self.weight_decay:
                    u = u + self.weight_decay * p
                p.sub_(lr * u)
        self.count += 1

    def _sgd(self, lr):
        """The SGD update over every leaf at once (`torch._foreach_*`: a few
        launches for all of them on a card), each operation rounded as the
        per-leaf form rounds it: u = g + (wd * p), t = (t * m) + u,
        p = p - (lr * t), with nesterov p = p - (lr * (u + (m * t)))."""
        params, trace = self.params, self.slots["trace"]
        u = [p.grad for p in params]
        if self.weight_decay:
            u = torch._foreach_add(u, torch._foreach_mul(params,
                                                         self.weight_decay))
        # t * m in place with m a float64 host scalar tensor: the plain
        # scalar form rounds m to a bf16 trace's dtype first on the CPU
        torch._foreach_mul_(trace, torch.tensor(self.momentum,
                                                dtype=torch.float64))
        torch._foreach_add_(trace, u)
        step = trace
        if self.nesterov:
            step = torch._foreach_add(u, torch._foreach_mul(trace,
                                                            self.momentum))
        torch._foreach_sub_(params, torch._foreach_mul(step, lr))

    def state_dict(self):
        return {"count": self.count, "slots": self.slots}

    def load_state_dict(self, state):
        self.count = int(state["count"])
        for name, tensors in state["slots"].items():
            for dst, src in zip(self.slots[name], tensors):
                dst.copy_(src)


def build_schedule(opt_cfg, sched_cfg, steps_per_epoch: int):
    """The schedule an (OptimizerConfig, LRScheduleConfig) names."""
    if sched_cfg.name == "multistep":
        return multistep_schedule(
            opt_cfg.lr, sched_cfg.milestones, sched_cfg.gamma,
            steps_per_epoch, sched_cfg.warmup_epochs,
        )
    if sched_cfg.name == "cosine":
        return cosine_schedule(
            opt_cfg.lr, steps_per_epoch * max(sched_cfg.milestones,
                                              default=90))
    if sched_cfg.name == "constant":
        return constant_schedule(opt_cfg.lr)
    raise ValueError(f"unknown lr schedule {sched_cfg.name!r}")


def build_optimizer(params, opt_cfg, sched_cfg, steps_per_epoch: int):
    """(parameters, OptimizerConfig, LRScheduleConfig) -> Optimizer, whose
    `schedule` is the learning rate per update count."""
    schedule = build_schedule(opt_cfg, sched_cfg, steps_per_epoch)
    if opt_cfg.name == "sgd":
        return Optimizer(params, schedule, "sgd", momentum=opt_cfg.momentum,
                         nesterov=opt_cfg.nesterov,
                         weight_decay=opt_cfg.weight_decay)
    if opt_cfg.name == "adamw":
        return Optimizer(params, schedule, "adamw",
                         weight_decay=opt_cfg.weight_decay)
    raise ValueError(f"unknown optimizer {opt_cfg.name!r}")

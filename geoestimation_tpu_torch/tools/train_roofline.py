"""The train step against its roofline, and the data axis's collectives.

    python -m geoestimation_tpu_torch.tools.train_roofline [--batch 256] \\
        [--iters 20] [--arch resnet50] [--remat] [--peak_flops F] \\
        [--peak_bw B]
    python -m geoestimation_tpu_torch.tools.train_roofline \\
        --collectives N [--batch 256] [--arch resnet50] [--cpu_crop 64]

The port of the JAX package's `tools/train_roofline.py`, with its flags.

1. Measured step time: `tools/bench_train.py`'s step (augment -> bf16
   forward in train mode -> the heads' summed cross-entropy -> backward ->
   SGD with momentum) on seeded data on the card, timed over `--iters`
   steps between two synchronizations.
2. Ideal step time, from one step's own counts: `flops`, the operations of
   its convolutions and matrix products, forward and backward
   (`torch.utils.flop_counter.FlopCounterMode`), and `bytes_accessed`, the
   bytes of the input and output tensors of every aten operator the step
   dispatches (`BytesAccessed`; views and uninitialized allocations move
   none and are left out), and the bytes the train-mode BatchNorm kernels
   count for themselves (`ops.bn_train`). Eager PyTorch fuses nothing else,
   so this is the nearly unfused counterpart of XLA's per-op "bytes
   accessed" of the JAX tool: each operator's inputs read and its outputs
   written once. The ideal is the larger of flops / peak_flops and bytes /
   peak_bw; the peaks default to an H100 SXM's bf16 tensor-core rate and
   HBM3 rate (`tools/card.py`).
   It runs on a CUDA card only and raises without one.
3. `--collectives N`: N ranks on the CPU (gloo, spawned here) each take one
   data-axis train step of the port at `--cpu_crop` px on its rows of the
   global batch (`train/step.py`, `parallel/multihost.py`), every
   `torch.distributed` collective issued inside the step recorded with its
   payload bytes and caller, then bucketed: `grad_psum` (the flattened
   gradient all-reduce, `multihost.all_reduce_grads`), `bn_stats` (the
   BatchNorm sums over the ranks in `models/resnet.py` `batch_norm_train`,
   `multihost.sum_over_ranks`, and the backward's per-channel sums,
   `multihost.sum_bn_grads`) and
   `other_small` (the loss's valid counts and the metrics). The
   counterpart of the JAX tool's all-reduces in the step lowered over an
   N-device virtual CPU mesh; there XLA's combiner may merge or split
   them, here each call is one operation.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import sys
import tempfile
import traceback

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

from ..ops.bn_train import bn_train
from .card import H100_BF16_FLOPS, H100_BYTES_PER_S

RANK_TIMEOUT_S = 600
COLLECTIVES = ("all_reduce", "broadcast", "all_gather",
               "all_gather_into_tensor", "reduce_scatter_tensor")
# allocations that neither read nor write a tensor's bytes
NO_BYTES = ("empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided")


class BytesAccessed(TorchDispatchMode):
    """Sums the bytes of every aten operator's tensor inputs and outputs
    dispatched under it (`bytes`, over `ops` operators), leaving out views
    and uninitialized allocations."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and \
                func.overloadpacket.__name__ not in NO_BYTES:
            self.ops += 1
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def count_step(step):
    """(flops, bytes_accessed, operators) of one call of step() each: the
    counts of two consecutive steps, the train-mode BatchNorm kernels'
    launches and bytes among them."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as flops:
        step()
    launches, kernel_bytes = bn_train.launches, bn_train.bytes
    with BytesAccessed() as nbytes:
        step()
    # the BatchNorm kernels dispatch no aten operator: they count their own
    return (float(flops.get_total_flops()),
            float(nbytes.bytes + bn_train.bytes - kernel_bytes),
            nbytes.ops + bn_train.launches - launches)


def roofline(args):
    from . import bench_train
    from .card import require_cuda

    require_cuda("train_roofline")
    state, _, _, step = bench_train.setup(args.batch, args.arch, args.remat,
                                          "cuda")
    device = next(state.model.parameters()).device
    flops, bytes_accessed, _ = count_step(step)
    ms, _ = bench_train.measure(step, args.iters, device)

    t_compute = flops / args.peak_flops
    t_hbm = bytes_accessed / args.peak_bw
    ideal = max(t_compute, t_hbm)
    out = {
        "metric": f"train_roofline_{args.arch}"
                  + ("_remat" if args.remat else ""),
        "batch": args.batch,
        "measured_ms": round(ms, 2),
        "images_per_sec_per_chip": round(args.batch * 1e3 / ms, 1),
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "ideal_compute_ms": round(t_compute * 1e3, 2),
        "ideal_hbm_ms": round(t_hbm * 1e3, 2),
        "ideal_ms": round(ideal * 1e3, 2),
        "bound_by": "compute" if t_compute >= t_hbm else "hbm",
        "measured_over_ideal": round(ms / 1e3 / ideal, 3) if ideal else None,
        "platform": device.type,
    }
    print(json.dumps(out), flush=True)
    return out


# -- the collective audit ------------------------------------------------------

def _bucket(frame):
    """The bucket of a collective issued with `frame` the innermost Python
    frame: by the functions on the stack."""
    names = set()
    while frame is not None:
        names.add(frame.f_code.co_qualname)
        frame = frame.f_back
    if "all_reduce_grads" in names:
        return "grad_psum"
    if "batch_norm_train" in names or "sum_bn_grads" in names:
        return "bn_stats"
    return "other_small"


def _caller(frame):
    """The innermost function of the port that issued a collective."""
    while frame is not None and "geoestimation_tpu_torch" not in \
            frame.f_code.co_filename:
        frame = frame.f_back
    return frame.f_code.co_qualname if frame is not None else "?"


@contextlib.contextmanager
def recording():
    """Within the block every `torch.distributed` collective of COLLECTIVES
    is recorded as (name, payload bytes, bucket, caller) in the yielded
    list: the payload is the first tensor argument (the rank's own
    contribution)."""
    import torch.distributed as dist

    ops, saved = [], {name: getattr(dist, name) for name in COLLECTIVES}

    def wrap(name, fn):
        def recorded(*args, **kwargs):
            t = next(a for a in (*args, *kwargs.values())
                     if isinstance(a, torch.Tensor))
            frame = sys._getframe(1)
            ops.append((name, t.numel() * t.element_size(), _bucket(frame),
                        _caller(frame)))
            return fn(*args, **kwargs)
        return recorded

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield ops
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def audit_step(batch, arch, remat, crop):
    """One data-axis train step of this rank on its rows of a seeded global
    batch of `batch` (`crop` px crops of crop + 8 px images), on the CPU;
    the collectives it issued (`recording`)."""
    from ..parallel import multihost
    from ..train.step import train_step
    from . import bench_train

    rank, n = multihost.process_index(), multihost.process_count()
    if batch % n:
        raise SystemExit(f"train_roofline: --batch {batch} does not split "
                         f"over {n} ranks")
    state, images, labels, _ = bench_train.setup(
        batch, arch, remat, "cpu", crop=crop, base=crop + 8)
    rows = slice(rank * batch // n, (rank + 1) * batch // n)
    with recording() as ops:
        train_step(state, images[rows], labels[:, rows], 0, crop=crop)
    return ops


def _rank(rank, n, port, args, out_dir):
    """The body of one spawned rank: writes its collectives (or its
    traceback) under out_dir."""
    torch.set_num_threads(1)
    from ..parallel import multihost

    try:
        multihost.initialize(f"127.0.0.1:{port}", n, rank, cpu=True,
                             timeout_s=RANK_TIMEOUT_S)
        ops = audit_step(args["batch"], args["arch"], args["remat"],
                         args["cpu_crop"])
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(ops, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        multihost.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(n, args):
    """Each of n spawned gloo ranks' recorded collectives, in rank order;
    raises with a failed rank's traceback."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="train_roofline_") as tmp:
        port = _free_port()
        procs = [ctx.Process(target=_rank, args=(r, n, port, args, tmp))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(RANK_TIMEOUT_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        for r, p in enumerate(procs):
            err = os.path.join(tmp, f"rank{r}.err")
            if p.exitcode != 0:
                why = open(err).read() if os.path.exists(err) else ""
                raise RuntimeError(f"train_roofline: rank {r} exited "
                                   f"{p.exitcode}\n{why}")
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                out.append([tuple(op) for op in json.load(f)])
    return out


def collectives(args):
    per_rank = run_ranks(args.collectives, {
        "batch": args.batch, "arch": args.arch, "remat": args.remat,
        "cpu_crop": args.cpu_crop})
    ops = per_rank[0]
    if any(r != ops for r in per_rank[1:]):
        raise RuntimeError("train_roofline: the ranks issued different "
                           "collectives")
    buckets = {"bn_stats": {"n": 0, "bytes": 0},
               "grad_psum": {"n": 0, "bytes": 0},
               "other_small": {"n": 0, "bytes": 0}}
    callers = {}
    for name, nbytes, bucket, caller in ops:
        for b in (buckets[bucket], callers.setdefault(
                f"{name} in {caller}", {"n": 0, "bytes": 0})):
            b["n"] += 1
            b["bytes"] += nbytes
    out = {
        "metric": f"train_step_collectives_{args.arch}",
        "mesh_devices": args.collectives,
        "batch": args.batch,
        "buckets": buckets,
        "bn_share_of_collective_bytes": round(
            buckets["bn_stats"]["bytes"]
            / max(1, sum(v["bytes"] for v in buckets.values())), 6),
        "callers": callers,
    }
    print(json.dumps(out, indent=1), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--arch", default="resnet50")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--peak_flops", type=float, default=H100_BF16_FLOPS)
    p.add_argument("--peak_bw", type=float, default=H100_BYTES_PER_S)
    p.add_argument("--collectives", type=int, default=0,
                   help="N: skip the card's roofline and audit the "
                        "collectives of one train step in N gloo ranks "
                        "on the CPU")
    p.add_argument("--cpu_crop", type=int, default=64,
                   help="crop for the CPU collective audit (the "
                        "collectives' payloads are per parameter and per "
                        "BatchNorm channel, not per pixel)")
    args = p.parse_args(argv)
    if args.collectives:
        return collectives(args)
    return roofline(args)


if __name__ == "__main__":
    main()

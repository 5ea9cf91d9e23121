"""Feature-TTA self-distillation (`models/tta_distill.py`).

    python -m geoestimation_tpu_torch.tools.tta_distill \\
        --checkpoint DIR --image_dir IMAGES --out OUT [--steps 300] \\
        [--lr 1e-4] [--optimizer adam|sgd] [--crops 5|10] [--level 3] \\
        [--train_scope all|rest] [--anchor_weight 1.0] [--cpu]

The port of the JAX package's `tools/tta_distill.py`: fine-tunes a
checkpoint so its feature-TTA output matches its own frozen exact ten-crop
output (per-head KL of the TTA-folded probabilities, no labels; anchored on
the exact path), keeps the snapshot with the lowest verdict pair (feature-TTA
KL + exact KL, over the whole distillation set, at each log point and at
the end), and writes to OUT

  * a standard identity-BN checkpoint every CLI consumes (serve it with
    --feature_tta; measure parity against the ORIGINAL checkpoint's exact
    tables, `tools.quant_study --ref_checkpoint`), and
  * `int8_scales.json` (`source: "distill"`), calibrated on the
    distillation images, so `--precision 8` serves without a calibration.

Distillation images: any unlabeled in-domain folder, decoded to the eval base
geometry, in full batches; the teacher's log-probs are computed once per
batch. `--optimizer adam` is `train.optim.Optimizer("adamw",
weight_decay=0)`, optax's adam. Runs on CUDA unless --cpu; the step runs
cuDNN through autograd (no hand-written kernel).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description="feature-TTA self-distillation "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--hparams", default=None)
    p.add_argument("--image_dir", required=True,
                   help="unlabeled in-domain images (decoded to the eval "
                        "base geometry)")
    p.add_argument("--out", required=True)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--optimizer", default="adam", choices=["sgd", "adam"],
                   help="adam (default) is robust to the badly scaled "
                        "per-layer gradients of a near-zero KL start")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--images", type=int, default=512,
                   help="distillation set size (cycled)")
    p.add_argument("--crops", type=int, default=10, choices=[5, 10])
    p.add_argument("--level", type=int, default=3)
    p.add_argument("--crop", type=int, default=224)
    p.add_argument("--train_scope", default="all", choices=["all", "rest"],
                   help="'rest': freeze the shared trunk, train only the "
                        "per-crop stages + head")
    p.add_argument("--anchor_weight", type=float, default=1.0,
                   help="weight of the KL(teacher || student_EXACT) anchor "
                        "term; 0 disables")
    p.add_argument("--tta_fold", default="prob_mean")
    p.add_argument("--calib_images", type=int, default=64)
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of CUDA")
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    from ..checkpoint import save_checkpoint
    from ..data.image_folder import iter_image_folder
    from ..eval.engine import default_scales_path, resolve_device
    from ..models.qat import (
        fold_variables,
        folded_leaves,
        restore,
        snapshot,
        unfold_to_variables,
    )
    from ..models.quant import (
        calibrate,
        pack_scales,
        quantize_model,
        weights_hash,
    )
    from ..models.tta_distill import (
        build_exact_tta_apply,
        build_ftta_apply,
        make_distill_step,
        make_eval_kl,
        teacher_log_probs,
    )
    from ..train.optim import Optimizer, constant_schedule
    from ._load import load_with_partitionings

    device = resolve_device("cpu" if args.cpu else "cuda")
    config, sd, _, n_classes = load_with_partitionings(args.checkpoint,
                                                       args.hparams)
    arch = config.model_params.arch

    # --- distillation set: fixed base batches from the folder ----------
    batches, n = [], 0
    for fb in iter_image_folder(args.image_dir, batch_size=args.batch_size):
        good = fb.images[np.asarray(fb.valid)]
        if len(good) == args.batch_size:
            batches.append(good)
            n += len(good)
        if n >= args.images:
            break
    if not batches:
        p.error(f"no full batches of {args.batch_size} decodable images "
                f"in {args.image_dir}")
    print(f"distilling on {n} images ({len(batches)} batches of "
          f"{args.batch_size}), {args.crops}-crop, level {args.level}, "
          f"scope {args.train_scope}", flush=True)
    dev_batches = [torch.as_tensor(b).to(device) for b in batches]

    folded = fold_variables(sd, arch=arch, device=device, requires_grad=True)

    # --- teacher: frozen exact ten-crop log-probs, once per batch ------
    exact_apply = build_exact_tta_apply(arch, n_classes, crop=args.crop,
                                        n_crops=args.crops)
    t0 = time.time()
    teachers = [teacher_log_probs(exact_apply, folded, b, args.crops,
                                  args.tta_fold) for b in dev_batches]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"teacher pass done ({time.time() - t0:.0f}s)", flush=True)

    # --- distill loop ---------------------------------------------------
    ftta_apply = build_ftta_apply(arch, n_classes, level=args.level,
                                  crop=args.crop, n_crops=args.crops)
    leaves = [t for _, t in folded_leaves(folded)]
    optimizer = (Optimizer(leaves, constant_schedule(args.lr), "adamw",
                           weight_decay=0.0) if args.optimizer == "adam"
                 else Optimizer(leaves, constant_schedule(args.lr), "sgd",
                                momentum=args.momentum))
    step_fn = make_distill_step(
        ftta_apply, optimizer, args.crops, tta_fold=args.tta_fold,
        train_scope=args.train_scope, level=args.level, arch=arch,
        exact_apply=exact_apply if args.anchor_weight else None,
        anchor_weight=args.anchor_weight)
    eval_kl_fn = make_eval_kl(ftta_apply, exact_apply, args.crops,
                              tta_fold=args.tta_fold)

    def full_eval_kl():
        """The verdict pair (feature-TTA KL, exact KL) over the whole set."""
        tot_f = tot_e = 0.0
        for b, t in zip(dev_batches, teachers):
            kf, ke = eval_kl_fn(folded, b, t)
            tot_f += float(kf)
            tot_e += float(ke)
        return tot_f / len(batches), tot_e / len(batches)

    # best-verdict retention over the whole distillation set, so the tool
    # never exports a snapshot worse than its start
    kf0, ke0 = full_eval_kl()
    best_kl, best = kf0 + ke0, snapshot(folded)
    print(f"start     ftta-kl {kf0:.5f}  exact-kl {ke0:.5f}", flush=True)
    t0 = time.time()
    for i in range(args.steps):
        if i and (i % args.log_every == 0 or i == args.steps - 1):
            kf, ke = full_eval_kl()
            new_best = kf + ke < best_kl
            if new_best:
                best_kl, best = kf + ke, snapshot(folded)
            print(f"step {i:5d}  ftta-kl {kf:.5f}  exact-kl {ke:.5f}  "
                  f"({time.time() - t0:.0f}s)"
                  + ("  [best]" if new_best else ""), flush=True)
        j = i % len(batches)
        step_fn(folded, dev_batches[j], teachers[j])
    # the final post-update state gets a verdict too
    kf, ke = full_eval_kl()
    if kf + ke < best_kl:
        best_kl, best = kf + ke, snapshot(folded)
    print(f"final     ftta-kl {kf:.5f}  exact-kl {ke:.5f}", flush=True)
    print(f"exporting best snapshot (total kl {best_kl:.5f})", flush=True)

    # --- export ----------------------------------------------------------
    restore(folded, best)
    new_sd = unfold_to_variables(folded, sd, arch=arch)
    save_checkpoint(args.out, new_sd, config)
    # int8 scales for the distilled weights (the distillation set doubles
    # as the calibration set)
    calib = batches[:max(1, args.calib_images // args.batch_size)]
    scales = calibrate(new_sd, calib, arch=arch, crop=args.crop,
                       device=device)
    packed = pack_scales(scales,
                         weights_hash=weights_hash(quantize_model(
                             new_sd, arch=arch)),
                         source="distill",
                         n_images=sum(len(b) for b in calib))
    spath = default_scales_path(args.out)
    with open(spath, "w") as f:
        json.dump(packed, f, indent=1, sort_keys=True)
    print(f"wrote distilled checkpoint to {args.out} and scales to {spath}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Quantization-aware fine-tuning for the int8 serving path.

    python -m geoestimation_tpu_torch.tools.qat_finetune \\
        --checkpoint DIR --out OUT [--steps 200] [--lr 1e-4] \\
        [--anchor_weight W] [--upper_ste] [--eval_images 128] \\
        [--eval_every 20] [--eval_dir DIR] [--calib_images 64] [--cpu]

The port of the JAX package's `tools/qat_finetune.py`: load a checkpoint
whose hparams carry `train_params.train_shards`, calibrate the serving
activation scales once on training images, fine-tune the BN-folded float32
network THROUGH the int8 fake-quantizer (`models/qat.py`) on the training
data, keep the best snapshot by the parity proxy KL(float32 teacher ||
student through the quantizer) at eval geometry (step -1, the original
weights, is plain PTQ and can win: then the original weights ship), and
write to OUT

  * a standard checkpoint (identity BatchNorms) that every CLI and the bf16
    path consume unchanged, and
  * `int8_scales.json` (`source: "qat"`), so `--precision 8` serves with the
    scales QAT trained against (the engine keeps them for that weights
    hash).

`--anchor_weight` adds KL(frozen float32 teacher || student) to the loss;
`--upper_ste` passes the gradient through the upper clip. The crops are the
checkpoint's training views (`train_params.train_crop_scale`), their draws
from `(--seed, step)` (`ingest.pipeline.step_generator`). Runs on CUDA
unless --cpu; the train step runs cuDNN through autograd (no hand-written
kernel).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description="int8 QAT fine-tune "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--hparams", default=None)
    p.add_argument("--out", required=True,
                   help="output checkpoint directory")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--batch_size", type=int, default=None,
                   help="default: train_params.batch_size")
    p.add_argument("--anchor_weight", type=float, default=0.0,
                   help="weight of the per-head KL(teacher || student) "
                        "anchor against the FROZEN original network; 0 = "
                        "plain CE fine-tuning")
    p.add_argument("--upper_ste", action="store_true",
                   help="pass gradient 1 through the UPPER fake-quant clip "
                        "(and both clips at the signed _y3 site) instead of "
                        "the masked-STE zero")
    p.add_argument("--eval_images", type=int, default=128,
                   help="size of the parity-proxy slice for best-snapshot "
                        "retention: every --eval_every steps KL(teacher || "
                        "student) at eval geometry (center crop) on these "
                        "images; the best snapshot seen is exported, step "
                        "-1 (plain PTQ, the original weights) included. 0 "
                        "disables retention (export the last step)")
    p.add_argument("--eval_every", type=int, default=20)
    p.add_argument("--eval_dir", default=None,
                   help="image folder to draw the parity-proxy slice from "
                        "(unlabeled is fine); default: the train stream")
    p.add_argument("--calib_images", type=int, default=64)
    p.add_argument("--calib_stat", default="absmax",
                   choices=["absmax", "p999", "p9999"])
    p.add_argument("--calib_headroom", type=float, default=1.0)
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of CUDA")
    return p


def _take(it, n):
    """(list of uint8 batches, count): the first n images of `it`."""
    out, got = [], 0
    while got < n:
        images = next(it)
        take = min(n - got, len(images))
        out.append(images[:take])
        got += take
    return out, got


def _folder_images(image_dir, n):
    from ..data.image_folder import iter_image_folder

    out, got = [], 0
    for fb in iter_image_folder(image_dir, batch_size=32):
        good = fb.images[np.asarray(fb.valid)]
        take = min(n - got, len(good))
        if take:
            out.append(good[:take])
            got += take
        if got >= n:
            break
    return out, got


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    from ..checkpoint import save_checkpoint
    from ..data.loader import ShardBatcher, load_label_csv
    from ..eval.engine import default_scales_path, resolve_device
    from ..ingest.pipeline import eval_pipeline_s8
    from ..models.qat import (
        build_qat_apply,
        fold_variables,
        folded_leaves,
        make_qat_train_step,
        restore,
        snapshot,
        teacher_student_kl,
        unfold_to_variables,
    )
    from ..models.quant import (
        calibrate,
        pack_scales,
        quantize_model,
        weights_hash,
    )
    from ..train.optim import Optimizer, constant_schedule
    from ._load import load_with_partitionings

    device = resolve_device("cpu" if args.cpu else "cuda")
    config, sd, parts, n_classes = load_with_partitionings(args.checkpoint,
                                                           args.hparams)
    mp, tp = config.model_params, config.train_params
    if not tp.train_shards:
        p.error("checkpoint hparams carry no train_params.train_shards — "
                "QAT needs the training data the checkpoint was built on")
    batch_size = args.batch_size or tp.batch_size

    label_map = None
    if tp.train_labels:
        label_map, _ = load_label_csv(
            tp.train_labels, mp.partitionings.shortnames, with_scene=True)
    batcher = iter(ShardBatcher(
        list(tp.train_shards), batch_size=batch_size,
        partitionings=None if label_map else parts, label_map=label_map,
        shuffle=True, seed=args.seed, repeat=True,
        num_workers=tp.num_workers))
    images_of = (fb.images for fb in batcher)

    def dev(a):
        return torch.as_tensor(np.asarray(a)).to(device)

    # --- calibrate serving scales (static during QAT) ------------------
    calib, n_calib = _take(images_of, args.calib_images)
    print(f"calibrating on {n_calib} training images "
          f"(stat={args.calib_stat}, headroom={args.calib_headroom:g})",
          flush=True)
    scales = calibrate(sd, calib, arch=mp.arch, stat=args.calib_stat,
                       headroom=args.calib_headroom, crop=tp.image_size,
                       device=device)

    # --- QAT loop ------------------------------------------------------
    folded = fold_variables(sd, arch=mp.arch, device=device,
                            requires_grad=True)
    optimizer = Optimizer([t for _, t in folded_leaves(folded)],
                          constant_schedule(args.lr), "sgd",
                          momentum=args.momentum)
    apply_fn = build_qat_apply(mp.arch, scales, n_classes=n_classes,
                               upper_ste=args.upper_ste)
    crop_scale = tuple(tp.train_crop_scale) if tp.train_crop_scale else None
    if crop_scale:
        print(f"augmenting with the checkpoint's train_crop_scale="
              f"{crop_scale}", flush=True)
    teacher_apply = teacher_folded = None
    if args.anchor_weight or args.eval_images:
        # the frozen float32 teacher: the same folded graph without the
        # quantizer, on a fold of its own
        teacher_apply = build_qat_apply(mp.arch, scales, n_classes=n_classes,
                                        fake_quant=False)
        teacher_folded = fold_variables(sd, arch=mp.arch, device=device)
    if args.anchor_weight:
        print(f"anchored QAT: KL(teacher || student) x "
              f"{args.anchor_weight:g}", flush=True)

    # --- parity-proxy slice for best-snapshot retention ----------------
    kl_fn = None
    if args.eval_images:
        ev, n_ev = (_folder_images(args.eval_dir, args.eval_images)
                    if args.eval_dir else _take(images_of, args.eval_images))
        x_ev = eval_pipeline_s8(dev(np.concatenate(ev, axis=0)), n_crops=1,
                                crop=tp.image_size).float()
        t_ev = [t.clone() for t in teacher_apply(teacher_folded, x_ev)]

        @torch.no_grad()
        def kl_fn():
            return float(teacher_student_kl(t_ev, apply_fn(folded, x_ev)))

        print(f"snapshot retention: {n_ev}-image parity proxy at eval "
              f"geometry, every {args.eval_every} steps", flush=True)
    step_fn = make_qat_train_step(
        apply_fn, optimizer, crop=tp.image_size,
        label_smoothing=tp.label_smoothing, crop_scale=crop_scale,
        anchor_weight=args.anchor_weight, teacher_apply=teacher_apply,
        teacher_folded=teacher_folded)

    t0 = time.time()
    best_kl, best_step, best = None, -1, None
    if kl_fn is not None:
        # step "-1" = the original weights through the quantizer: plain
        # PTQ at these scales. QAT must beat this to export anything.
        best_kl, best = kl_fn(), snapshot(folded)
        print(f"step    -1  proxy_kl {best_kl:.5f}  (PTQ floor)", flush=True)
    for i in range(args.steps):
        fb = next(batcher)
        m = step_fn(folded, dev(fb.images), dev(fb.labels), args.seed, i)
        if kl_fn is not None and (
                (i + 1) % args.eval_every == 0 or i == args.steps - 1):
            kl = kl_fn()
            if kl < best_kl:
                best_kl, best_step, best = kl, i, snapshot(folded)
        if i % args.log_every == 0 or i == args.steps - 1:
            extra = (f"  anchor_kl {float(m['anchor_kl']):.4f}"
                     if "anchor_kl" in m else "")
            print(f"step {i:5d}  loss {float(m['loss']):.4f}{extra}  "
                  f"({time.time() - t0:.0f}s)", flush=True)
    batcher.close()   # stops the producer thread

    if kl_fn is not None:
        restore(folded, best)
        if best_step < 0:
            print("snapshot retention: NO QAT step improved the parity "
                  "proxy over plain PTQ — exporting the ORIGINAL "
                  f"weights (proxy_kl {best_kl:.5f}). PTQ (the grid "
                  "sweep in tools/quant_study.py) is this checkpoint's "
                  "serving answer.", flush=True)
        else:
            print(f"snapshot retention: exporting step {best_step} "
                  f"(proxy_kl {best_kl:.5f})", flush=True)

    # --- export --------------------------------------------------------
    new_sd = unfold_to_variables(folded, sd, arch=mp.arch)
    save_checkpoint(args.out, new_sd, config)
    packed = pack_scales(scales,
                         weights_hash=weights_hash(quantize_model(
                             new_sd, arch=mp.arch)),
                         source="qat", n_images=n_calib,
                         stat=args.calib_stat, headroom=args.calib_headroom)
    spath = default_scales_path(args.out)
    with open(spath, "w") as f:
        json.dump(packed, f, indent=1, sort_keys=True)
    print(f"wrote QAT checkpoint to {args.out} and scales to {spath}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

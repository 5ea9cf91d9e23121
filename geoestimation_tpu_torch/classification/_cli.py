"""Flags and engine construction shared by the inference and test CLIs.

The flag names are those of `classification/inference.py` and
`classification/test.py`; each CLI adds the multi-process flags
(`parallel.multihost.add_coordinator_args`) with its own help.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..parallel import multihost


def add_shared_args(p: argparse.ArgumentParser):
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint directory (hparams.yaml + state_dict.pt)")
    p.add_argument("--hparams", default=None,
                   help="optional explicit hparams.yaml (default: bundled "
                        "with the checkpoint)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_workers", type=int, default=None,
                   help="host decode threads")
    p.add_argument("--crops", type=int, default=10, choices=[1, 5, 10],
                   help="TTA crops per image")
    p.add_argument("--precision", type=int, default=16, choices=[8, 16, 32],
                   help="16=bfloat16 backbone, 32=float32, 8=int8 PTQ "
                        "serving precision (models/quant.py; calibrated on "
                        "the first batch)")
    p.add_argument("--gpu", action="store_true",
                   help="accepted for reference CLI compatibility; the port "
                        "runs on CUDA by default")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of CUDA")
    p.add_argument("--fast", action="store_true",
                   help="fold BatchNorm into conv weights at load "
                        "(identical predictions up to bf16 rounding)")
    p.add_argument("--tta_fold", default="prob_mean",
                   choices=["prob_mean", "log_mean", "logit_mean"],
                   help="how per-crop logits combine: prob_mean = mean of "
                        "softmax probs (reference convention, default), "
                        "log_mean = geometric, logit_mean = raw logits")
    p.add_argument("--fast_decode", action="store_true",
                   help="scaled DCT JPEG decode on the host ingest path "
                        "(faster on large photos; slightly different "
                        "pixels)")
    p.add_argument("--exact_tta", action="store_true",
                   help="torchvision-exact ten-crop on the host (TenCrop of "
                        "the full resized rectangle, not of a center "
                        "square): strict parity on non-square images for "
                        "imported reference checkpoints; forces --crops 10")
    add_feature_tta_args(p)
    add_calib_args(p)


def add_feature_tta_args(p: argparse.ArgumentParser):
    p.add_argument("--feature_tta", action="store_true",
                   help="feature-space ten-crop TTA: run the trunk once "
                        "per base image and crop at the layer3 feature "
                        "map (approximate at crop borders)")
    p.add_argument("--feature_tta_level", type=int, default=3,
                   choices=[1, 2, 3],
                   help="with --feature_tta: backbone stage whose feature "
                        "map is cropped (3 = least trunk work; 2 runs "
                        "layer3+4 per crop)")


def add_calib_args(p: argparse.ArgumentParser):
    """The int8 calibration flags (`--precision 8`), as the JAX CLIs."""
    p.add_argument("--calib_dir", default=None,
                   help="with --precision 8: deterministic calibration "
                        "set (first --calib_images of this dir in sorted "
                        "order); recalibrates unless the scales cache was "
                        "made from this set at these settings")
    p.add_argument("--calib_images", type=int, default=64,
                   help="images drawn from --calib_dir")
    p.add_argument("--calib_stat", default="auto",
                   choices=["auto", "absmax", "p999", "p9999"],
                   help="activation-range statistic; 'auto' (default) "
                        "scores absmax/p999/p9999 against the fp32 "
                        "forward on the calibration images and ships "
                        "the winner (models/quant.py autoselect_scales)")
    p.add_argument("--calib_headroom", type=float, default=1.0,
                   help="scale multiplier >1 trades resolution for "
                        "clipping margin")
    p.add_argument("--recalibrate", action="store_true",
                   help="with --precision 8: ignore any cached "
                        "int8_scales.json")


def int8_kwargs(args, persist=True):
    """The engine's int8 arguments from the parsed flags; the scales cache
    sits next to the checkpoint."""
    from ..eval.engine import default_scales_path

    return dict(int8=args.precision == 8,
                int8_scales_path=default_scales_path(args.checkpoint),
                calib_dir=args.calib_dir, calib_images=args.calib_images,
                calib_stat=args.calib_stat,
                calib_headroom=args.calib_headroom, int8_persist=persist,
                int8_recalibrate=args.recalibrate)


def default_calib_dir(args, image_dir):
    """int8 in several processes: each process calibrating on its own first
    batch would fit scales to its own file slice, N quantizers under one
    merged table. Without --calib_dir, every process calibrates on the
    first --calib_images of the FULL `image_dir` in sorted order
    (`InferenceEngine._calib_dir_batches` is unsliced), so all derive the
    same scales."""
    if (multihost.process_count() > 1 and args.precision == 8
            and not args.calib_dir):
        args.calib_dir = image_dir
        if multihost.process_index() == 0:
            print("int8 multi-process: defaulting --calib_dir to "
                  f"{image_dir} so every process calibrates on the same "
                  "images", flush=True)


def process_slice():
    """This process's (p, n) share of a folder, None in one process."""
    n = multihost.process_count()
    return (multihost.process_index(), n) if n > 1 else None


def make_engine(args, use_pallas=False):
    from ..checkpoint import load_checkpoint
    from ..eval.engine import InferenceEngine

    config, state_dict = load_checkpoint(args.checkpoint,
                                         hparams_path=args.hparams)
    return InferenceEngine(
        config,
        state_dict,
        n_crops=args.crops,
        dtype=torch.float32 if args.precision == 32 else torch.bfloat16,
        search_dirs=[os.path.dirname(os.path.abspath(args.checkpoint)),
                     args.checkpoint, os.getcwd()],
        fast=args.fast,
        use_pallas=use_pallas,
        tta_mode=("feature" if args.feature_tta
                  else "host_exact" if args.exact_tta else "device"),
        tta_fold=args.tta_fold,
        feature_tta_level=args.feature_tta_level,
        fast_decode=args.fast_decode,
        device=multihost.local_device(args.cpu),
        **int8_kwargs(args),
    )

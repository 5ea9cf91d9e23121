"""Converts a checkpoint of the JAX package (orbax) into the port's format.

    python convert_orbax.py --checkpoint ORBAX_DIR --output PORT_DIR \\
        [--step N] [--hparams hparams.yaml]

Reads ORBAX_DIR as the JAX inference CLIs do (`load_for_inference`: the
best step by val_loss, else the latest, unless --step), maps its variables
onto the port's classifier (`geoestimation_tpu_torch.convert.
from_jax_variables`; an ISN checkpoint keeps its scene heads) and writes
PORT_DIR (`hparams.yaml` + `state_dict.pt`), which the port's CLIs and
server take as --checkpoint. The checkpoint's `int8_scales.json`, where it
has one, is copied beside it: both packages key that cache by the same
weights hash. Partitioning paths in the hparams are kept as they are, and
resolve as they do for the JAX CLIs (absolute, or against the checkpoint's
parent, the checkpoint and the working directory).

Reading orbax needs JAX, so this script sits outside both packages; the
port itself never imports JAX.
"""

from __future__ import annotations

import argparse
import os
import shutil


def build_parser():
    p = argparse.ArgumentParser(
        description="Convert a JAX (orbax) checkpoint for the PyTorch port")
    p.add_argument("--checkpoint", required=True,
                   help="the JAX package's checkpoint directory")
    p.add_argument("--output", required=True,
                   help="the port checkpoint directory to write")
    p.add_argument("--step", type=int, default=None,
                   help="the step to convert (default: best by val_loss, "
                        "else the latest)")
    p.add_argument("--hparams", default=None,
                   help="explicit hparams.yaml (default: bundled with the "
                        "checkpoint)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from geoestimation_tpu.train.checkpoint import load_for_inference
    from geoestimation_tpu_torch.checkpoint import HPARAMS_NAME, save_checkpoint
    from geoestimation_tpu_torch.convert import from_jax_variables
    from geoestimation_tpu_torch.eval.engine import (
        default_scales_path,
        resolve_partitioning_paths,
    )
    from geoestimation_tpu_torch.geo import load_partitionings
    from geoestimation_tpu_torch.utils.config import load_config

    _, state = load_for_inference(args.checkpoint, step=args.step,
                                  hparams_path=args.hparams)
    config = load_config(args.hparams
                         or os.path.join(args.checkpoint, HPARAMS_NAME))
    mp = config.model_params
    search = [os.path.dirname(os.path.abspath(args.checkpoint)),
              args.checkpoint, os.getcwd()]
    parts = load_partitionings(
        resolve_partitioning_paths(mp.partitionings.files, search),
        names=list(mp.partitionings.shortnames))
    state_dict = from_jax_variables(state["params"], state["batch_stats"],
                                    mp.arch, [len(p) for p in parts])
    save_checkpoint(args.output, state_dict, config)
    scales = default_scales_path(args.checkpoint)
    if os.path.exists(scales):
        shutil.copy(scales, default_scales_path(args.output))
    print(f"wrote {args.output} ({mp.arch}, "
          f"{'ISN, ' if mp.scene_gating else ''}"
          f"heads {[len(p) for p in parts]})")


if __name__ == "__main__":
    main()

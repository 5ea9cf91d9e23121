"""Training CLI of the port, with the JAX package's flags.

    python -m geoestimation_tpu_torch.classification.train_base \\
        --config configs/baseM.yml [--max_steps N] [--no_resume] \\
        [--checkpoint_dir DIR] [--profile_dir DIR] [--cpu]

One YAML config carries the model and trainer parameters (the schema of
`utils/config.py`). Runs on CUDA unless --cpu. The multi-process flags are
parsed and refused: multi-process training is not ported yet.
"""

from __future__ import annotations

import argparse
import os

from ._cli import add_coordinator_args, check_ported


def build_parser():
    p = argparse.ArgumentParser(description="Train the multi-partitioning "
                                            "geo classifier (PyTorch/CUDA "
                                            "port)")
    p.add_argument("--config", default="configs/baseM.yml",
                   help="YAML config (reference README.md:216)")
    p.add_argument("--max_steps", type=int, default=None,
                   help="stop after N optimizer steps (smoke runs)")
    p.add_argument("--no_resume", action="store_true",
                   help="ignore existing checkpoints")
    p.add_argument("--checkpoint_dir", default=None,
                   help="override train_params.checkpoint_dir")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace (trace.json) here")
    p.add_argument("--cpu", action="store_true",
                   help="train on the CPU instead of CUDA")
    add_coordinator_args(p)
    return p


def main(argv=None):
    """Returns the Trainer, after its fit."""
    args = build_parser().parse_args(argv)
    check_ported(args)

    from ..train.loop import Trainer
    from ..utils.config import load_config

    config = load_config(args.config)
    if args.checkpoint_dir:
        config.train_params.checkpoint_dir = args.checkpoint_dir
    if args.profile_dir:
        config.train_params.profile_dir = args.profile_dir
    trainer = Trainer(
        config,
        search_dirs=[os.path.dirname(os.path.abspath(args.config)),
                     os.getcwd()],
        device="cpu" if args.cpu else "cuda",
    )
    trainer.fit(max_steps=args.max_steps, resume=not args.no_resume)
    return trainer


if __name__ == "__main__":
    main()

"""Training CLI of the port, with the JAX package's flags.

    python -m geoestimation_tpu_torch.classification.train_base \\
        --config configs/baseM.yml [--max_steps N] [--no_resume] \\
        [--checkpoint_dir DIR] [--profile_dir DIR] [--cpu] \\
        [--coordinator HOST:PORT --num_processes N --process_id P]

One YAML config carries the model and trainer parameters (the schema of
`utils/config.py`). Runs on CUDA unless --cpu. In N processes (the same
command with its own --process_id on each), `train_params.batch_size` stays
the global batch and each process feeds batch_size / N rows of it
(`parallel/multihost.py`).
"""

from __future__ import annotations

import argparse
import os

from ..parallel import multihost


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
    multihost.add_coordinator_args(
        p, extra_help="Run the SAME command on every process with its own "
                      "--process_id (launch recipe in parallel/multihost.py)")
    return p


def main(argv=None):
    """Returns the Trainer, after its fit."""
    args = build_parser().parse_args(argv)
    with multihost.joined(args):
        return _train(args)


def _train(args):
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
        device=multihost.local_device(args.cpu),
    )
    trainer.fit(max_steps=args.max_steps, resume=not args.no_resume)
    return trainer


if __name__ == "__main__":
    main()

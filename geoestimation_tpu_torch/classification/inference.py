"""Batch inference CLI of the port, with the reference's flags.

    python -m geoestimation_tpu_torch.classification.inference \\
        --checkpoint DIR --image_dir IMAGES [--output preds.csv] \\
        [--precision 8|16|32] [--crops 1|5|10] [--exact_tta] \\
        [--feature_tta [--feature_tta_level 1|2|3]] [--fast [--pallas]] \\
        [--calib_dir DIR] [--calib_stat auto] [--cpu] \\
        [--coordinator HOST:PORT --num_processes N --process_id P]

Writes a CSV of (img_id, p_key, pred_class, pred_lat, pred_lng) rows, one
per partitioning key including `hierarchy` (reference README.md:98-124).
DIR holds hparams.yaml and state_dict.pt. Runs on CUDA unless --cpu. In N
processes, process P predicts sorted(files)[P::N] and writes
<output>.part-P-of-N.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..parallel import multihost
from ._cli import (
    add_shared_args,
    default_calib_dir,
    make_engine,
    process_slice,
)


def build_parser():
    p = argparse.ArgumentParser(
        description="GeoEstimation batch inference over an image dir "
                    "(PyTorch/CUDA port)")
    add_shared_args(p)
    p.add_argument("--image_dir", required=True)
    p.add_argument("--output", default=None,
                   help="output CSV path (default: stdout)")
    p.add_argument("--pallas", action="store_true",
                   help="with --fast: fused bottleneck kernel for the "
                        "stride-1 blocks of layer1 and layer2")
    multihost.add_coordinator_args(
        p, extra_help="Each process predicts sorted(files)[p::n] and "
                      "writes <output>.part-P-of-N (concatenate the parts "
                      "for the full CSV; rows don't overlap). Requires "
                      "--output")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    with multihost.joined(args):
        _predict(args)


def _predict(args):
    proc_id, n_procs = multihost.process_index(), multihost.process_count()
    if n_procs > 1 and not args.output:
        raise SystemExit("multi-process inference requires --output "
                         "(each process writes its own part file)")
    default_calib_dir(args, args.image_dir)
    engine = make_engine(args, use_pallas=args.pallas)
    df = engine.predict_dir(args.image_dir, batch_size=args.batch_size,
                            num_workers=args.num_workers,
                            process_slice=process_slice())
    if args.output:
        out = args.output
        if n_procs > 1:
            out = f"{args.output}.part-{proc_id}-of-{n_procs}"
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        df.to_csv(out, index=False)
        print(f"wrote {len(df)} rows to {out}")
    else:
        df.to_csv(sys.stdout, index=False)


if __name__ == "__main__":
    main()

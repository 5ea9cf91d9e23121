"""Batch inference CLI of the port, with the reference's flags.

    python -m geoestimation_tpu_torch.classification.inference \\
        --checkpoint DIR --image_dir IMAGES [--output preds.csv] \\
        [--precision 8|16|32] [--crops 1|5|10] [--exact_tta] \\
        [--feature_tta [--feature_tta_level 1|2|3]] [--fast [--pallas]] \\
        [--calib_dir DIR] [--calib_stat auto] [--cpu]

Writes a CSV of (img_id, p_key, pred_class, pred_lat, pred_lng) rows, one
per partitioning key including `hierarchy` (reference README.md:98-124).
DIR holds hparams.yaml and state_dict.pt. Runs on CUDA unless --cpu.
"""

from __future__ import annotations

import argparse
import os
import sys

from ._cli import add_shared_args, make_engine


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
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    engine = make_engine(args, use_pallas=args.pallas)
    df = engine.predict_dir(args.image_dir, batch_size=args.batch_size,
                            num_workers=args.num_workers)
    if args.output:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)),
                    exist_ok=True)
        df.to_csv(args.output, index=False)
        print(f"wrote {len(df)} rows to {args.output}")
    else:
        df.to_csv(sys.stdout, index=False)


if __name__ == "__main__":
    main()

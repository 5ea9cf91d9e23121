"""Evaluation CLI of the port -- the README-style accuracy tables.

    python -m geoestimation_tpu_torch.classification.test \\
        --checkpoint DIR --image_dirs D1 [D2 ...] --meta_files M1 [M2 ...] \\
        [--precision 8|16|32] [--crops 1|5|10] [--exact_tta] [--fast] \\
        [--feature_tta [--feature_tta_level 1|2|3]] [--calib_dir DIR] \\
        [--json out.json] [--cpu] \\
        [--coordinator HOST:PORT --num_processes N --process_id P]

Each meta CSV has the columns IMG_ID, LAT, LON; prints GCD threshold
accuracies at {1, 25, 200, 750, 2500} km per partitioning and for the
hierarchical f* prediction (reference README.md:136-187). Runs on CUDA
unless --cpu. In N processes, process P scores sorted(files)[P::N], the
counts merge across processes, and process 0 prints the tables and writes
--json.
"""

from __future__ import annotations

import argparse
import json
import os

from ..parallel import multihost
from ._cli import (
    add_shared_args,
    default_calib_dir,
    make_engine,
    process_slice,
)


def build_parser():
    p = argparse.ArgumentParser(
        description="GeoEstimation evaluation, GCD threshold accuracies "
                    "(PyTorch/CUDA port)")
    add_shared_args(p)
    p.add_argument("--image_dirs", nargs="+", required=True)
    p.add_argument("--meta_files", nargs="+", required=True)
    p.add_argument("--json", dest="json_out", default=None,
                   help="also dump results as JSON to this path")
    multihost.add_coordinator_args(
        p, extra_help="Each process scores sorted(files)[p::n] and the GCD "
                      "counts merge across processes -- the printed table "
                      "covers the full directory")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if len(args.image_dirs) != len(args.meta_files):
        raise SystemExit("--image_dirs and --meta_files must pair up "
                         "(reference README.md:153-156)")
    with multihost.joined(args):
        return _evaluate(args)


def _evaluate(args):
    from ..data.image_folder import load_meta_csv
    from ..eval.engine import format_accuracy_table

    rank0 = multihost.process_index() == 0
    default_calib_dir(args, args.image_dirs[0])
    engine = make_engine(args)
    all_results = {}
    for image_dir, meta_file in zip(args.image_dirs, args.meta_files):
        results = engine.evaluate_dir(
            image_dir, load_meta_csv(meta_file), batch_size=args.batch_size,
            num_workers=args.num_workers, process_slice=process_slice())
        name = os.path.basename(os.path.normpath(image_dir))
        all_results[name] = results
        if rank0:
            print(format_accuracy_table(results, dataset_name=name))
            missing = results.get("_n_images_without_meta")
            if missing:
                print(f"  ({missing} images had no meta row; excluded)")
    if args.json_out and rank0:
        with open(args.json_out, "w") as f:
            json.dump(all_results, f, indent=2)
    return all_results


if __name__ == "__main__":
    main()

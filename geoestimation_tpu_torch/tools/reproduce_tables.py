"""Reproduce the reference's published accuracy tables (README.md:169-187).

    python -m geoestimation_tpu_torch.tools.reproduce_tables \\
        --checkpoint DIR --im2gps_dir D --im2gps_meta M \\
        [--im2gps3k_dir D --im2gps3k_meta M] [--precision 32|16|8] \\
        [--calib_dir DIR] [--max_delta PT] [--crops 10] [--cpu]
    # a reference Lightning checkpoint, imported first:
    #   --torch_ckpt epoch=014-val_loss=18.4833.ckpt --cell_files C M F

The port of the JAX package's `tools/reproduce_tables.py`: given Im2GPS /
Im2GPS3k and a checkpoint (a port checkpoint directory, or a Lightning
`.ckpt` imported on the fly by `tools.import_torch_checkpoint`), it runs the
port's `classification.test` with the reference's settings (host-exact
ten-crop, the softmax-probability TTA fold) and prints its numbers beside
the published rows, with the deltas against the 0.5-pt parity budget.
`--precision 8 --max_delta N` also runs float32 and exits 1 if an int8 GCD
cell moves more than N points from it (the serving-precision gate). Runs on
CUDA unless --cpu.
"""

from __future__ import annotations

import argparse
import os
import sys

# Published rows (reference README.md:169-187). Keys are p_keys; values are
# % within {1, 25, 200, 750, 2500} km.
PUBLISHED = {
    "im2gps": {
        "coarse": (9.3, 31.6, 49.8, 67.1, 78.9),       # base(M, c)
        "middle": (13.9, 34.6, 48.1, 68.4, 79.3),      # base(M, m)
        "fine": (15.6, 39.2, 48.9, 65.8, 78.5),        # base(M, f)
        "hierarchy": (14.8, 37.6, 48.9, 68.4, 78.9),   # base(M, f*)
    },
    "im2gps3k": {
        "coarse": (6.2, 24.3, 36.3, 51.7, 67.0),
        "middle": (8.3, 26.2, 35.7, 51.4, 66.5),
        "fine": (9.9, 27.3, 36.2, 51.2, 66.4),
        "hierarchy": (10.1, 28.0, 36.9, 51.1, 67.0),   # primary target
    },
}
THRESHOLDS = (1, 25, 200, 750, 2500)
PARITY_BUDGET_PT = 0.5


def render(dataset: str, ours: dict) -> str:
    pub = PUBLISHED[dataset]
    lines = [f"== {dataset} (ours vs reference README.md tables)"]
    header = "p_key".ljust(11) + "".join(
        f"{t} km".rjust(8) for t in THRESHOLDS
    ) + "   max|delta|"
    lines.append(header)
    worst_overall = 0.0
    for key in ("coarse", "middle", "fine", "hierarchy"):
        if key not in ours:
            continue
        got = [100.0 * v for v in ours[key].values()]
        deltas = [g - p for g, p in zip(got, pub[key])]
        worst = max(abs(d) for d in deltas)
        worst_overall = max(worst_overall, worst)
        lines.append(
            key.ljust(11) + "".join(f"{g:8.1f}" for g in got)
            + f"   {worst:9.2f}"
        )
        lines.append(
            "  (ref)".ljust(11) + "".join(f"{p:8.1f}" for p in pub[key])
        )
    verdict = ("PASS" if worst_overall <= PARITY_BUDGET_PT else "FAIL")
    lines.append(
        f"-- parity vs {PARITY_BUDGET_PT} pt budget: {verdict} "
        f"(max |delta| = {worst_overall:.2f} pt)"
    )
    return "\n".join(lines)


def build_parser():
    p = argparse.ArgumentParser(
        description="Reproduce the published Im2GPS/Im2GPS3k tables "
                    "(PyTorch/CUDA port)")
    p.add_argument("--checkpoint", help="port checkpoint directory")
    p.add_argument("--torch_ckpt",
                   help="reference Lightning .ckpt to import first (needs "
                        "--cell_files)")
    p.add_argument("--cell_files", nargs="+",
                   help="partitioning CSVs coarse->fine (the import)")
    p.add_argument("--arch", default="resnet50")
    p.add_argument("--im2gps_dir")
    p.add_argument("--im2gps_meta")
    p.add_argument("--im2gps3k_dir")
    p.add_argument("--im2gps3k_meta")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--crops", type=int, default=10, choices=[1, 5, 10],
                   help="ten-crop is the reference's table protocol; reduce "
                        "only for smoke runs (the verdict is meaningless "
                        "at crops != 10)")
    p.add_argument("--precision", type=int, default=32, choices=[8, 16, 32],
                   help="32 (default, strict parity), 16, or 8 (int8 PTQ "
                        "serving precision)")
    p.add_argument("--max_delta", type=float, default=None,
                   help="with --precision 8: also run fp32 and exit 1 if "
                        "any int8 GCD cell deviates from our fp32 table by "
                        "more than this many percentage points")
    p.add_argument("--calib_dir", default=None,
                   help="with --precision 8: deterministic calibration set "
                        "(classification.test --calib_dir)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of CUDA")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.max_delta is not None and args.precision != 8:
        raise SystemExit("--max_delta is the int8 acceptance gate; use it "
                         "with --precision 8")

    ckpt = args.checkpoint
    if args.torch_ckpt:
        if not args.cell_files:
            raise SystemExit("--torch_ckpt requires --cell_files")
        from . import import_torch_checkpoint as imp

        ckpt = ckpt or os.path.join(
            os.path.dirname(args.torch_ckpt) or ".", "imported")
        imp.main(["--torch_ckpt", args.torch_ckpt,
                  "--cell_files", *args.cell_files,
                  "--output", ckpt, "--arch", args.arch])
    if not ckpt:
        raise SystemExit("need --checkpoint or --torch_ckpt")

    datasets = []
    if args.im2gps_dir:
        datasets.append(("im2gps", args.im2gps_dir, args.im2gps_meta))
    if args.im2gps3k_dir:
        datasets.append(("im2gps3k", args.im2gps3k_dir, args.im2gps3k_meta))
    if not datasets:
        raise SystemExit(
            "no datasets given — pass --im2gps_dir/--im2gps_meta and/or "
            "--im2gps3k_dir/--im2gps3k_meta (images per reference "
            "README.md:129-143)")

    from ..classification.test import main as test_main

    def run(image_dir, meta, precision):
        flags = [
            "--checkpoint", ckpt,
            "--image_dirs", image_dir,
            "--meta_files", meta,
            "--crops", str(args.crops),
            "--tta_fold", "prob_mean",
            "--batch_size", str(args.batch_size),
            "--precision", str(precision),
        ]
        if args.crops == 10:
            # host-exact ten-crop is the parity protocol (it forces 10
            # crops, so smoke runs at fewer crops crop on the device)
            flags.append("--exact_tta")
        if precision == 8 and args.calib_dir:
            flags += ["--calib_dir", args.calib_dir]
        if args.cpu:
            flags.append("--cpu")
        results = test_main(flags)
        ours = results[os.path.basename(os.path.normpath(image_dir))]
        return {k: v for k, v in ours.items() if not k.startswith("_")}

    gate_ok = True
    for name, image_dir, meta in datasets:
        if not meta:
            raise SystemExit(f"--{name}_meta required (IMG_ID,LAT,LON)")
        ours = run(image_dir, meta, args.precision)
        print()
        print(render(name, ours))
        if args.max_delta is not None:
            # the serving-precision gate: our int8 against OUR fp32
            ours32 = run(image_dir, meta, 32)
            worst = 0.0
            for key in ours:
                if key not in ours32:
                    continue
                for t in ours[key]:
                    worst = max(worst, abs(100.0 * (ours[key][t]
                                                    - ours32[key][t])))
            ok = worst <= args.max_delta + 1e-9   # inclusive budget
            gate_ok = gate_ok and ok
            print(f"-- int8 serving gate [{name}]: max |int8 - fp32| = "
                  f"{worst:.2f} pt vs {args.max_delta} pt budget: "
                  f"{'PASS' if ok else 'FAIL'}")
    if args.max_delta is not None and not gate_ok:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

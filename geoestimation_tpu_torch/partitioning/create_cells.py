"""Partitioning CLI of the port: build an adaptive S2 cell partitioning
from a training CSV. The counterpart of `partitioning/create_cells.py` (the
reference's `partitioning/create_cells.py`, reference README.md:225-239),
with the same flags, defaults, messages and output, on the port's
`geo.create_cells` (numpy, no JAX).

  python -m geoestimation_tpu_torch.partitioning.create_cells \
      --dataset META.csv --output cells_50_5000.csv --img_max 5000

Flags keep the documented names: -v/--verbose --dataset --output
--img_min --img_max --lvl_min --lvl_max --column_img_path --column_lat
--column_lng (reference README.md:227-238).
"""

from __future__ import annotations

import os
import sys

# Running this file by path puts THIS directory (not the repo root) on
# sys.path. Make the package importable either way; `python -m
# geoestimation_tpu_torch.partitioning.create_cells` is unaffected.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import argparse

import pandas as pd


def build_parser():
    p = argparse.ArgumentParser(
        description="Create an adaptive S2 cell partitioning"
    )
    p.add_argument("-v", "--verbose", action="store_true",
                   help="verbose output (per-split-round progress)")
    p.add_argument("--dataset", required=True,
                   help="CSV with image path + lat/lng columns")
    p.add_argument("--output", required=True, help="output cell CSV")
    p.add_argument("--img_min", type=int, default=50,
                   help="min images per cell (cells below are dropped)")
    p.add_argument("--img_max", type=int, default=1000,
                   help="max images per cell (cells above are split)")
    p.add_argument("--lvl_min", type=int, default=2,
                   help="starting S2 level")
    p.add_argument("--lvl_max", type=int, default=30,
                   help="maximum S2 level")
    p.add_argument("--column_img_path", default="IMG_ID")
    p.add_argument("--column_lat", default="LAT")
    p.add_argument("--column_lng", default="LON")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from geoestimation_tpu_torch.geo import create_cells

    df = pd.read_csv(args.dataset)
    cols = {c.lower(): c for c in df.columns}

    def col(name):
        if name in df.columns:
            return name
        if name.lower() in cols:
            return cols[name.lower()]
        raise SystemExit(f"column {name!r} not in {args.dataset!r} "
                         f"(has {list(df.columns)})")

    lat = df[col(args.column_lat)].to_numpy(float)
    lng = df[col(args.column_lng)].to_numpy(float)
    result = create_cells(
        lat, lng,
        img_min=args.img_min, img_max=args.img_max,
        lvl_min=args.lvl_min, lvl_max=args.lvl_max,
        verbose=args.verbose,
    )
    result.partitioning.to_csv(args.output)
    print(
        f"{len(result.partitioning)} cells "
        f"({result.n_images_kept}/{result.n_images_total} images kept, "
        f"{result.n_rounds} split rounds) -> {args.output}"
    )


if __name__ == "__main__":
    main()

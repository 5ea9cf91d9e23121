"""Assign per-image class labels for each partitioning (the port's CLI).

The counterpart of `partitioning/assign_classes.py`, with the same flags,
messages and output, on the port's `geo` (numpy, no JAX): join the
train/val meta CSVs (IMG_ID, LAT, LON, ...) with the partitionings, writing
one label column per partitioning shortname. Output CSV:
IMG_ID,<shortname...> -- read by the training loader
(`data/loader.load_label_csv`).

  python -m geoestimation_tpu_torch.partitioning.assign_classes \
      --dataset META.csv --output labels.csv --cell_files C1.csv C2.csv
"""

from __future__ import annotations

import os
import sys

# Running this file by path puts THIS directory (not the repo root) on
# sys.path. Make the package importable either way; `python -m
# geoestimation_tpu_torch.partitioning.assign_classes` is unaffected.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import argparse

import numpy as np
import pandas as pd


def build_parser():
    p = argparse.ArgumentParser(description="Assign S2 cell class labels")
    p.add_argument("--dataset", required=True,
                   help="meta CSV with IMG_ID, LAT, LON")
    p.add_argument("--output", required=True, help="output label CSV")
    p.add_argument("--cell_files", nargs="+", required=True,
                   help="partitioning cell CSVs, coarse -> fine")
    p.add_argument("--shortnames", nargs="+", default=None,
                   help="column names (default: derived from filenames)")
    p.add_argument("--column_img_path", default="IMG_ID")
    p.add_argument("--column_lat", default="LAT")
    p.add_argument("--column_lng", default="LON")
    p.add_argument("--drop_unassigned", action="store_true",
                   help="drop rows outside every partitioning cell")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from geoestimation_tpu_torch.geo import (
        assign_classes,
        load_partitionings,
    )

    parts = load_partitionings(args.cell_files, names=args.shortnames)
    df = pd.read_csv(args.dataset)
    cols = {c.lower(): c for c in df.columns}

    def col(name):
        return name if name in df.columns else cols[name.lower()]

    lat = df[col(args.column_lat)].to_numpy(float)
    lng = df[col(args.column_lng)].to_numpy(float)
    labels = assign_classes(lat, lng, parts)  # (P, N)
    out = pd.DataFrame({"IMG_ID": df[col(args.column_img_path)].astype(str)})
    for p, part in enumerate(parts):
        out[part.name] = labels[p]
    if args.drop_unassigned:
        keep = (labels >= 0).all(axis=0)
        out = out[keep]
        print(f"dropped {int((~keep).sum())} unassigned rows")
    out.to_csv(args.output, index=False)
    print(f"{len(out)} label rows -> {args.output}")


if __name__ == "__main__":
    main()

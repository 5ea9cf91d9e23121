"""Remove label rows whose image is missing from the shards (the port's
tool).

The counterpart of `filter_by_downloaded_images.py`, with the same flags and
output, on the port's `data.shards.iter_records`: after downloading,
train/val label CSVs are filtered so they match what is in the shards (dead
Flickr URLs make the dataset smaller than the original, reference
README.md:194, 212-213).

  python -m geoestimation_tpu_torch.tools.filter_by_downloaded_images \
      --shards 'SHARDS/*.msgpack' --labels train_labels.csv
"""

from __future__ import annotations

import argparse

import pandas as pd


def build_parser():
    p = argparse.ArgumentParser(description="Filter label CSVs by the ids "
                                            "present in msgpack shards")
    p.add_argument("--shards", nargs="+", required=True,
                   help="shard files or globs")
    p.add_argument("--labels", nargs="+", required=True,
                   help="label CSVs to filter (IMG_ID column)")
    p.add_argument("--suffix", default="_filtered",
                   help="output filename suffix")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..data.shards import iter_records

    present = {
        str(rec["id"]) for rec in iter_records(args.shards)
        if rec.get("id") is not None
    }
    print(f"{len(present)} image ids in shards")
    for path in args.labels:
        df = pd.read_csv(path)
        cols = {c.lower(): c for c in df.columns}
        id_col = cols.get("img_id", df.columns[0])
        keep = df[id_col].astype(str).isin(present)
        out_path = path.rsplit(".", 1)[0] + args.suffix + ".csv"
        df[keep].to_csv(out_path, index=False)
        print(f"{path}: kept {int(keep.sum())}/{len(df)} -> {out_path}")


if __name__ == "__main__":
    main()

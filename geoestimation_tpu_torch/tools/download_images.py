"""Image downloader of the port: packs URL-CSV images into msgpack
training shards.

The counterpart of `download_images.py`, with the same flags and messages,
on the port's `data.shards.write_shard`:

  python -m geoestimation_tpu_torch.tools.download_images \
      --output resources/images/mp16 --url_csv resources/mp16_urls.csv \
      --shuffle [--size_suffix ""]

Downloads are fault-tolerant (the dataset "might be smaller than the
original", reference README.md:194): failed URLs are skipped and counted,
and a run where every download failed says the host likely has no network.
Any URL `urllib` opens works, `file://` ones too.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import csv
import os
import random
import sys


def build_parser():
    p = argparse.ArgumentParser(description="Download images into msgpack "
                                            "shards")
    p.add_argument("--output", required=True, help="output shard directory")
    p.add_argument("--url_csv", required=True,
                   help="CSV of image id,url rows")
    p.add_argument("--shuffle", action="store_true",
                   help="shuffle download order (README.md:205)")
    p.add_argument("--size_suffix", default="z",
                   help="flickr size suffix appended to URLs ('' = original;"
                        " README.md:206)")
    p.add_argument("--shard_size", type=int, default=1000,
                   help="records per msgpack shard")
    p.add_argument("--num_workers", type=int, default=16)
    p.add_argument("--timeout", type=float, default=10.0)
    return p


def iter_url_rows(path):
    with open(path, newline="") as f:
        reader = csv.reader(f)
        rows = list(reader)
    # tolerate a header row
    if rows and not rows[0][-1].startswith("http"):
        rows = rows[1:]
    for row in rows:
        if len(row) >= 2:
            yield row[0], row[-1]


def apply_size_suffix(url: str, suffix: str) -> str:
    if not suffix:
        return url
    root, ext = os.path.splitext(url)
    return f"{root}_{suffix}{ext}"


def fetch(url: str, timeout: float):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..data.shards import write_shard

    rows = list(iter_url_rows(args.url_csv))
    if args.shuffle:
        random.Random(0).shuffle(rows)
    print(f"{len(rows)} urls from {args.url_csv}")

    os.makedirs(args.output, exist_ok=True)
    shard_idx, buf, n_ok, n_fail = 0, [], 0, 0

    def flush():
        nonlocal shard_idx, buf
        if buf:
            path = os.path.join(args.output, f"shard_{shard_idx:05d}.msgpack")
            write_shard(buf, path)
            shard_idx += 1
            buf = []

    # Bounded in-flight window: submitting every URL up front would retain
    # all futures (and their result blobs) — unbounded memory at MP-16
    # scale (~4.7M images).
    window = args.num_workers * 4
    with cf.ThreadPoolExecutor(args.num_workers) as ex:
        it = iter(rows)
        futs = {}

        def submit_next():
            try:
                img_id, url = next(it)
            except StopIteration:
                return False
            futs[ex.submit(
                fetch, apply_size_suffix(url, args.size_suffix),
                args.timeout
            )] = img_id
            return True

        for _ in range(window):
            if not submit_next():
                break
        while futs:
            fut = next(cf.as_completed(futs))
            img_id = futs.pop(fut)
            try:
                buf.append({"id": img_id, "image": fut.result()})
                n_ok += 1
                if len(buf) >= args.shard_size:
                    flush()
            except Exception:
                n_fail += 1
            submit_next()
    flush()
    print(f"done: {n_ok} downloaded, {n_fail} failed, "
          f"{shard_idx} shards in {args.output}")
    if n_ok == 0 and n_fail > 0:
        print("every download failed — this environment likely has no "
              "network egress", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

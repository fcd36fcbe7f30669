"""Dump scalar training summaries from a model_dir to CSV (counterpart of
tools/tb_scalars.py of the JAX package).

Reads `summaries*.jsonl` first and every `events.out.tfevents.*` file
second (TB v2 scalars: rank-0 tensors, or `simple_value`), through the
port's own TFRecord and protobuf readers, with both CRCs of every record
checked: a later row for the same (tag, step), a restart's, wins. Writes
one `<out_dir>/<tag with / as _>.csv` per requested tag with the header
`step,<last part of the tag>` and rows sorted by step.

Usage:
  python -m compare_gan_torch.tools.tb_scalars --model_dir=/tmp/s3gan32 \
      --out_dir=docs/x --tags loss/d_0 loss/g
  (omit --tags to dump every scalar tag found)
"""

from __future__ import annotations

import argparse
import collections
import csv
import glob
import json
import os
import sys

import numpy as np

from compare_gan_torch.tf_io import events
from compare_gan_torch.tf_io import protobuf as pb


def _scalar(value: events.SummaryValue):
    """The value as a float, or None when it holds no scalar (a string or
    a non-scalar tensor, as the JAX tool's try/except skips them)."""
    if value.tensor is not None:
        try:
            return float(pb.parse_tensor(value.tensor))
        except (ValueError, TypeError):
            return None
    return value.simple_value


def read_scalars(model_dir, forms=("jsonl", "events")):
    """{tag: [(step, value), ...]} from the JSONL rows and the event files
    (or only the `forms` named), steps sorted, later duplicates (restarts)
    winning."""
    series = collections.defaultdict(dict)
    # JSONL rows first, event rows second, as the JAX tool reads them.
    if "jsonl" in forms:
        for path in sorted(glob.glob(os.path.join(model_dir,
                                                  "summaries*.jsonl"))):
            with open(path) as f:
                for line in f:
                    row = json.loads(line)
                    if "value" in row:
                        series[row["tag"]][row["step"]] = row["value"]
    if "events" in forms:
        for path in sorted(glob.glob(os.path.join(
                model_dir, "events.out.tfevents.*"))):
            for event in events.iter_events(path):
                for value in event.values:
                    scalar = _scalar(value)
                    if scalar is not None:
                        series[value.tag][event.step] = scalar
    return {tag: sorted(by_step.items())
            for tag, by_step in series.items()}


def forms_agree(model_dir):
    """(agree, tags): do the event files alone and the JSONL rows alone
    give the same series, tag by tag? An event holds the float32 scalar
    (as tf.summary.scalar writes it), a JSONL row the loop's float mean."""
    jsonl = read_scalars(model_dir, forms=("jsonl",))
    logged = read_scalars(model_dir, forms=("events",))
    tags = sorted(logged)
    agree = bool(tags) and tags == sorted(jsonl) and all(
        [(s, np.float32(v)) for s, v in jsonl[t]] == logged[t]
        for t in tags)
    return agree, tags


def write_csvs(series, out_dir, tags=None):
    """One CSV per tag of `tags` (default: every tag) in `out_dir`; returns
    {tag: path} of those written. Tags not in `series` are reported."""
    tags = tags if tags else sorted(series)
    os.makedirs(out_dir, exist_ok=True)
    missing = [t for t in tags if t not in series]
    if missing:
        print(f"WARNING: tags not found: {missing}; "
              f"available: {sorted(series)}", file=sys.stderr)
    written = {}
    for tag in tags:
        if tag not in series:
            continue
        out = os.path.join(out_dir, tag.replace("/", "_") + ".csv")
        with open(out, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["step", tag.split("/")[-1]])
            w.writerows(series[tag])
        print(f"{out}: {len(series[tag])} points")
        written[tag] = out
    return written


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--tags", nargs="*", default=None,
                        help="Scalar tags to dump (default: all found)")
    args = parser.parse_args(argv)
    write_csvs(read_scalars(args.model_dir), args.out_dir, args.tags)
    return 0


if __name__ == "__main__":
    sys.exit(main())

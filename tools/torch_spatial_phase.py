#!/usr/bin/env python3
"""The spatial layout on the card, alone: chip_smoke.py's kernel rows of
the spatial bands (SPATIAL_SHAPES, f32 and bf16, against the plain version
and SDPA, with their bounds) and its "spatial" phase (every case of
SPATIAL_CASES on its `data 1 x model k` grid of k gloo workers on cuda:0,
k = 2, or 8 for BigGAN-128 on eight bands, held to the one-process step,
with the faulty controls).

    python3 tools/torch_spatial_phase.py [--cases biggan128,biggan128_k8]
        [--out_dir chiprun_out/spatial]

Prints what the two phases of chip_smoke.py print, then one JSON line,
`spatial_phase {...}`: the band rows, the launches of each case's phase
precision, every case's gaps and the seconds of both parts; writes the
same object to `<out_dir>/spatial_phase.json`. Fails where chip_smoke.py
fails. Needs a CUDA card.
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cases", default=",".join(chip_smoke.SPATIAL_CASES),
                        help="comma-separated names of SPATIAL_CASES")
    parser.add_argument("--out_dir", default=os.path.join(
        ROOT, "chiprun_out", "spatial"))
    args = parser.parse_args(argv)
    import torch

    t0 = time.perf_counter()
    chip_smoke.check_device(torch)
    chip_smoke.build_kernels()
    rows = chip_smoke.compare_kernels(torch, chip_smoke.SPATIAL_SHAPES)[-1]
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="spatial_") as model_dir:
        launches, results = chip_smoke.run_spatial(
            torch, model_dir, args.cases.split(","))
    summary = {"rows": rows, "launches": launches, "results": results,
               "kernel_seconds": t1 - t0,
               "spatial_seconds": time.perf_counter() - t1}
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "spatial_phase.json"), "w") as f:
        json.dump(summary, f)
    print("spatial_phase " + json.dumps(summary))


if __name__ == "__main__":
    main()

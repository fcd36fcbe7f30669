"""Scale anchors for the FID proxy on an npz polygon dataset (counterpart
of tools/fid_anchors.py of the JAX package).

With the feature extractor the convergence evals use
($COMPARE_GAN_INCEPTION_NPZ, `eval_utils.get_inception_fn`) on --device:
  * real-vs-real: FID between the disjoint test and holdout splits (the
    metric's floor at this sample size), and
  * real-vs-noise: FID between uniform [0, 255] noise of the test split's
    shape (`RandomState(seed)`) and the test split.
A trained model's FID proxy is read against these two numbers.

Usage:
  COMPARE_GAN_DATA_DIR=... COMPARE_GAN_INCEPTION_NPZ=... \
    python -m compare_gan_torch.tools.fid_anchors \
      --dataset=convex_polygons_multiclass_128 [--max_per_split=4000] \
      [--out=/tmp/anchors.json] [--device=cuda]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from compare_gan_torch import eval_utils
from compare_gan_torch.metrics import fid_score


def _load_split(data_dir, dataset, split, max_n):
    with np.load(os.path.join(data_dir, dataset, f"{split}.npz")) as z:
        images = z["images"][:max_n]
    images = images.astype(np.float32)  # uint8 storage -> [0, 255] floats
    if images.shape[-1] == 1:
        images = np.tile(images, (1, 1, 1, 3))
    return images


def compute_anchors(dataset, max_per_split=4000, seed=0, device="cuda"):
    data_dir = os.environ["COMPARE_GAN_DATA_DIR"]
    test = _load_split(data_dir, dataset, "test", max_per_split)
    holdout = _load_split(data_dir, dataset, "holdout", max_per_split)
    noise = np.random.RandomState(seed).uniform(
        0.0, 255.0, size=test.shape).astype(np.float32)

    acts = {}
    for name, images in (("test", test), ("holdout", holdout),
                         ("noise", noise)):
        acts[name], _ = eval_utils.inception_transform_np(images,
                                                          device=device)
    return {
        "dataset": dataset,
        "num_per_split": int(test.shape[0]),
        "real_vs_real": float(fid_score.compute_fid_from_activations(
            acts["test"], acts["holdout"])),
        "real_vs_noise": float(fid_score.compute_fid_from_activations(
            acts["noise"], acts["test"])),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--max_per_split", type=int, default=4000)
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the Inception network.")
    args = parser.parse_args(argv)
    anchors = compute_anchors(args.dataset, args.max_per_split,
                              device=args.device)
    line = json.dumps(anchors)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return anchors


if __name__ == "__main__":
    main()

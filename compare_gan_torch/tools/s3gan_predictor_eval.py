"""Held-out predictor accuracy for S3GAN checkpoints (counterpart of
tools/s3gan_predictor_eval.py of the JAX package).

S3GAN's claim (Lucic et al. 2019, "High-Fidelity Image Generation With
Fewer Labels") is that D's label predictor, trained only on the labeled
fraction of the train split, learns to impute labels. Training summaries
show `class_loss_real` on that fraction only; this tool measures the
head's accuracy on a fully labeled held-out split at every checkpoint,
step 0 included.

The split is read unshuffled with the eval transform. Each batch goes
through `discriminator_with_additional_heads` with all-zero label rows
(the "no label" contract, so the head sees held-out examples as it sees
unlabeled train examples) in eval mode; the argmax of the aux logits
(output 3) is held against the true labels. A trailing partial batch is
dropped.

Usage (after an s3gan32_polygons_partial_oriented.gin run):
  python -m compare_gan_torch.tools.s3gan_predictor_eval \
      --model_dir /tmp/s3gan_poly \
      --gin_config example_configs/s3gan32_polygons_partial_oriented.gin \
      [--out_csv .../predictor_accuracy.csv] [--device=cuda]
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch

from compare_gan_torch import checkpoint as ckpt_lib
from compare_gan_torch import core


def load_labeled_split(dataset, split, num_examples):
    """(images [N, H, W, C] in [0, 1], labels [N]) of an eval split,
    unshuffled."""
    images, labels = [], []
    it = dataset._iter_examples(split, shuffle=False, repeat=False,
                                transform=dataset._eval_transform,
                                seed=dataset._seed, shard_by_host=False)
    for image, label in it:
        images.append(image)
        labels.append(int(label))
        if len(images) >= num_examples:
            it.close()
            break
    return np.stack(images).astype(np.float32), np.asarray(labels, np.int64)


@torch.no_grad()
def aux_logits(gan, x):
    """The predictor's logits of images `x` with all-zero label rows, D in
    eval mode, committing no state."""
    x = torch.as_tensor(x, device=gan.device)
    y = torch.zeros((x.shape[0], gan.dataset.num_classes),
                    device=gan.device)
    with core.no_state_updates():
        return gan.discriminator_with_additional_heads(
            x=x, y=y, is_training=False)[3]


def predictor_accuracy(gan, images, labels, batch_size=64):
    """Accuracy of the argmax of the aux logits against the true labels,
    over whole batches (the GAN's modules hold the restored checkpoint)."""
    correct = total = 0
    for i in range(len(images) // batch_size):
        sl = slice(i * batch_size, (i + 1) * batch_size)
        pred = aux_logits(gan, images[sl]).argmax(dim=1).cpu().numpy()
        correct += int((pred == labels[sl]).sum())
        total += batch_size
    return correct / max(total, 1)


def evaluate_model_dir(gan, model_dir, images, labels, batch_size=64,
                       split="test"):
    """One row per checkpoint of `model_dir`, in step order."""
    template = gan.init_state(0)
    chance = 1.0 / gan.dataset.num_classes
    rows = []
    for path in ckpt_lib.all_checkpoints(model_dir):
        ckpt_lib.restore_checkpoint(path, template)
        acc = predictor_accuracy(gan, images, labels, batch_size)
        step = ckpt_lib.step_of(path)
        rows.append({"step": step, "predictor_accuracy": f"{acc:.4f}",
                     "split": split, "num_examples": len(labels),
                     "chance": f"{chance:.4f}"})
        print(f"step {step}: held-out predictor accuracy {acc:.4f} "
              f"(chance {chance:.3f})")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model_dir", required=True)
    p.add_argument("--gin_config", required=True, nargs="+")
    p.add_argument("--gin_bindings", default=[], nargs="*")
    p.add_argument("--split", default="test")
    p.add_argument("--num_examples", type=int, default=2048)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--out_csv", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on.")
    args = p.parse_args(argv)

    from compare_gan_torch import config as gin
    from compare_gan_torch import datasets, runner_lib
    from compare_gan_torch import gans  # noqa: F401  (configurables)

    gin.parse_config_files_and_bindings(args.gin_config, args.gin_bindings)
    options = runner_lib.get_options_dict()
    dataset = datasets.get_dataset()
    gan = options["gan_class"](dataset=dataset, parameters=options,
                               model_dir=args.model_dir, device=args.device)
    if not hasattr(gan, "discriminator_with_additional_heads") or \
            not getattr(gan, "_use_predictor", False):
        raise SystemExit("Model has no predictor head "
                         "(need S3GAN.use_predictor=True).")

    images, labels = load_labeled_split(dataset, args.split,
                                        args.num_examples)
    if (labels < 0).any():
        raise SystemExit(f"Split {args.split} has unlabeled examples; "
                         "held-out accuracy needs true labels.")
    rows = evaluate_model_dir(gan, args.model_dir, images, labels,
                              args.batch_size, args.split)

    out_csv = args.out_csv or os.path.join(args.model_dir,
                                           "predictor_accuracy.csv")
    os.makedirs(os.path.dirname(os.path.abspath(out_csv)), exist_ok=True)
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()) if rows
                           else ["step", "predictor_accuracy"])
        w.writeheader()
        w.writerows(rows)
    print(f"Wrote {out_csv}")
    return rows


if __name__ == "__main__":
    main()

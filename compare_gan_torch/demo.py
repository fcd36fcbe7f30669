"""Sampling, interpolation and discriminator demo on a module export
(counterpart of examples/demo.py, the reference's colab demos
colabs/ssgan_demo.ipynb and colabs/s3gan_demo.ipynb).

Loads an export directory written by the runner (`<model_dir>/tfhub/<step>`)
or by `export.export_module`, of either package, then

  1. samples an image grid (one row per class with --per_class_grid),
  2. interpolates linearly in z between two latents, one class held fixed,
  3. runs the discriminator on a batch of images and prints its
     predictions.

Usage:
  python -m compare_gan_torch.demo --export_dir /tmp/gan/tfhub/10000 \\
      --out_dir /tmp/demo [--num_rows 3] [--num_cols 4] [--noise_seed 23] \\
      [--category 7] [--per_class_grid] [--num_interps 8] [--device cpu]

Writes samples.png and interpolation.png to --out_dir. Runs on the card
unless --device=cpu.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from compare_gan_torch import export, utils


def _parser():
    p = argparse.ArgumentParser(prog="compare_gan_torch.demo",
                                description=__doc__.split("\n")[0])
    p.add_argument("--export_dir", required=True,
                   help="Module export directory.")
    p.add_argument("--out_dir", default="compare_gan_demo",
                   help="Output directory.")
    p.add_argument("--num_rows", type=int, default=3, help="Sample grid rows.")
    p.add_argument("--num_cols", type=int, default=4,
                   help="Sample grid columns.")
    p.add_argument("--noise_seed", type=int, default=23,
                   help="Latent sampling seed.")
    p.add_argument("--category", type=int, default=None,
                   help="Class id for conditional models (default: random).")
    p.add_argument("--per_class_grid", action="store_true",
                   help="Conditional models: one grid row per class "
                   "(--num_rows is ignored).")
    p.add_argument("--num_interps", type=int, default=8,
                   help="Interpolation steps.")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:1, cpu).")
    return p


def _sample_z(spec, n, seed):
    """z as the export's gin snapshot draws it (the BigGAN recipes bind
    z.distribution_fn = @tf.random.normal): resolved inside the snapshot's
    config scope, so a fresh demo process honours the export, not its own
    empty config."""
    return export.sample_z(spec, n, seed=seed)


def _sample_labels(rng, n, spec, category):
    if not spec["conditional"]:
        return None
    if category is not None:
        return np.full((n,), category, dtype=np.int32)
    return rng.randint(0, spec["num_classes"], size=(n,)).astype(np.int32)


def interpolate(generate, z_a, z_b, labels, num_interps):
    """Images of `num_interps` latents linear from z_a to z_b (both
    [z_dim]), each with `labels` (one per step, or None)."""
    t = np.linspace(0.0, 1.0, num_interps, dtype=np.float32)[:, None]
    z = (1.0 - t) * z_a[None] + t * z_b[None]
    return _numpy(generate(z, labels))


def _numpy(images):
    return images.float().cpu().numpy()


def main(argv=None):
    args = _parser().parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    rng = np.random.RandomState(args.noise_seed)

    generate, spec = export.load_generator(args.export_dir, args.device)
    print(f"Loaded {spec['architecture']} (step {spec['step']}, dataset "
          f"{spec['dataset']}, conditional={spec['conditional']})")

    # 1. Sample grid (the colab's "Sampling" cell).
    num_rows = args.num_rows
    if args.per_class_grid:
        if not spec["conditional"]:
            raise ValueError("--per_class_grid needs a conditional model.")
        num_rows = spec["num_classes"]
        labels = np.repeat(np.arange(num_rows, dtype=np.int32),
                           args.num_cols)
    else:
        labels = _sample_labels(rng, num_rows * args.num_cols, spec,
                                args.category)
    z = _sample_z(spec, num_rows * args.num_cols, args.noise_seed)
    images = _numpy(generate(z, labels))
    path = os.path.join(args.out_dir, "samples.png")
    utils.save_images(utils.image_grid(images, (num_rows, args.num_cols)),
                      path)
    print(f"Wrote {num_rows}x{args.num_cols} sample grid to {path}")

    # 2. Interpolation (the colab's "Interpolation" cell): linear in z, one
    # class held fixed, one row.
    z_ab = _sample_z(spec, 2, args.noise_seed + 1)
    label = _sample_labels(rng, 1, spec, args.category)
    interp = interpolate(
        generate, z_ab[0], z_ab[1],
        None if label is None else np.repeat(label, args.num_interps),
        args.num_interps)
    path = os.path.join(args.out_dir, "interpolation.png")
    utils.save_images(np.concatenate(list(interp), axis=1), path)
    print(f"Wrote {args.num_interps}-step interpolation to {path}")

    # 3. Discriminator predictions (the colab's "Discriminator" cell): D
    # returns (prediction, logits, features), as the reference's hub
    # signature does.
    discriminate, _ = export.load_discriminator(args.export_dir, args.device)
    batch = rng.random_sample((4,) + tuple(spec["image_shape"])).astype(
        np.float32)
    predictions = _numpy(discriminate(
        batch, _sample_labels(rng, 4, spec, args.category))[0]).ravel()
    print("Discriminator prediction on random images:", predictions)
    return {"samples": images, "interpolation": interp,
            "predictions": predictions}


if __name__ == "__main__":
    main()

"""Import a reference (google/compare_gan) TF checkpoint into the port and
save it as the port's npz checkpoint, ready for eval (the counterpart of
the JAX package's tools/import_tf_checkpoint.py, with the same flags plus
--device).

Usage:
    python -m compare_gan_torch.import_tf_checkpoint \
        --checkpoint /path/to/model.ckpt-250000 \
        --model_dir /tmp/imported \
        --gin_config example_configs/biggan_imagenet128.gin \
        [--gin_bindings "..."] [--batch_size 8] [--device cuda]

`--checkpoint` accepts a TF Saver prefix, a reference model_dir (its
`checkpoint` pointer names the checkpoint) or a TF-Hub module export
directory. The gin config must describe the model the checkpoint was
trained with (reference checkpoints ship with an operative_config-<step>.gin
that translates directly). The checkpoint is read without TensorFlow.

Writes `<model_dir>/model.ckpt-<step>.npz` and
`operative_config-<step>.gin`. Then evaluate with the CLI:
    python -m compare_gan_torch.main --model_dir /tmp/imported \
        --schedule continuous_eval --gin_config <same config>
"""

from __future__ import annotations

import argparse
import os
import sys

from compare_gan_torch import checkpoint as ckpt_lib
from compare_gan_torch import config as gin
from compare_gan_torch import datasets, export, runner_lib
# Importing registers the configurables the .gin files reference.
from compare_gan_torch import gans  # noqa: F401


def _parser():
    p = argparse.ArgumentParser(prog="compare_gan_torch.import_tf_checkpoint",
                                description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", required=True,
                   help="TF Saver prefix / reference model_dir / TF-Hub "
                   "module dir to import.")
    p.add_argument("--model_dir", required=True,
                   help="Output model dir for the npz checkpoint.")
    p.add_argument("--gin_config", action="append", default=[],
                   help="Gin config file describing the trained model "
                   "(repeatable).")
    p.add_argument("--gin_bindings", action="append", default=[],
                   help="Extra gin binding (repeatable).")
    p.add_argument("--batch_size", type=int, default=8,
                   help="Template batch size (any value; variables are "
                   "batch-independent).")
    p.add_argument("--device", default="cuda",
                   help="torch device the model is built on (cuda, cpu).")
    return p


def main(argv=None) -> str:
    """Run the import; returns the written checkpoint's path."""
    args = _parser().parse_args(sys.argv[1:] if argv is None else argv)
    gin.parse_config_files_and_bindings(args.gin_config, args.gin_bindings)
    options = runner_lib.get_options_dict()
    dataset = datasets.get_dataset(seed=547)
    gan = options["gan_class"](dataset=dataset, parameters=options,
                               model_dir=args.model_dir, device=args.device)
    ts = export.import_reference_checkpoint(gan, args.checkpoint,
                                            batch_size=args.batch_size)
    step = int(ts.step)
    os.makedirs(args.model_dir, exist_ok=True)
    path = ckpt_lib.save_checkpoint(args.model_dir, ts, step)
    # The operative config, as training writes it, so the eval schedules
    # and the export loaders rebuild the same architecture.
    with open(os.path.join(args.model_dir,
                           f"operative_config-{step}.gin"), "w") as f:
        f.write(gin.config_str())
    print(f"Imported {args.checkpoint} (step {step}) -> {path}")
    return path


if __name__ == "__main__":
    main()

"""Binary to train GANs with the port (counterpart of
compare_gan_tpu/main.py).

Same flags as the JAX binary's --model_dir, --schedule, --gin_config,
--gin_bindings, --score_filename, --num_eval_averaging_runs,
--eval_every_steps and --data_fake_dataset, plus --device (default cuda;
there is no fallback to the CPU). Only the `train` schedule is ported.

Example:
  python -m compare_gan_torch.main --model_dir=/tmp/gan \
      --gin_config=example_configs/biggan_imagenet128.gin --data_fake_dataset
"""

from __future__ import annotations

import argparse
import logging
import sys

from compare_gan_torch import config as gin
from compare_gan_torch import datasets, runner_lib
# Importing registers the configurables the .gin files reference.
from compare_gan_torch import gans  # noqa: F401

logger = logging.getLogger(__name__)


def _bool(text):
    if text.lower() in ("1", "true", "yes"):
        return True
    if text.lower() in ("0", "false", "no"):
        return False
    raise argparse.ArgumentTypeError(f"Not a boolean: {text!r}")


def _parser():
    p = argparse.ArgumentParser(prog="compare_gan_torch.main",
                                description=__doc__.split("\n")[0])
    p.add_argument("--model_dir", required=True, help="Where to store files.")
    p.add_argument("--schedule", default="train",
                   help="Schedule to run (only `train` is ported).")
    p.add_argument("--gin_config", action="append", default=[],
                   help="Path of a config file (repeatable).")
    p.add_argument("--gin_bindings", action="append", default=[],
                   help="A gin binding (repeatable).")
    p.add_argument("--score_filename", default="scores.csv",
                   help="Evaluation CSV in model_dir (eval schedules).")
    p.add_argument("--num_eval_averaging_runs", type=int, default=3)
    p.add_argument("--eval_every_steps", type=int, default=5000)
    p.add_argument("--data_fake_dataset", type=_bool, nargs="?", const=True,
                   default=False,
                   help="Replace the real data by a fake dataset.")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:1, cpu).")
    return p


@gin.configurable("run_config")
def _get_run_config(model_dir, device, iterations_per_loop=100,
                    save_checkpoints_steps=5000, keep_checkpoint_max=1000,
                    tf_random_seed=None):
    """Gin-configurable run config (same binding names as the JAX
    binary's `run_config.*`)."""
    return runner_lib.RunConfig(
        model_dir=model_dir, tf_random_seed=tf_random_seed,
        iterations_per_loop=iterations_per_loop,
        save_checkpoints_steps=save_checkpoints_steps,
        keep_checkpoint_max=keep_checkpoint_max, device=device)


def main(argv=None):
    """Parse `argv` (default: sys.argv[1:]) and run the schedule; returns
    the train schedule's TrainReport."""
    args = _parser().parse_args(sys.argv[1:] if argv is None else argv)
    logger.info("Gin config: %s\nGin bindings: %s", args.gin_config,
                args.gin_bindings)
    datasets.set_fake_dataset(args.data_fake_dataset)
    gin.parse_config_files_and_bindings(args.gin_config, args.gin_bindings)
    run_config = _get_run_config(args.model_dir, args.device)
    task_manager = runner_lib.TaskManager(args.model_dir)
    options = runner_lib.get_options_dict()
    report = runner_lib.run_with_schedule(
        schedule=args.schedule, run_config=run_config,
        task_manager=task_manager, options=options)
    logger.info("Finished schedule %s.", args.schedule)
    return report


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    main()

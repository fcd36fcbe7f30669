"""Per-checkpoint EMA-vs-raw generator FID (counterpart of
tools/eval_ema_vs_raw.py of the JAX package).

Evaluates every checkpoint of a trained run but step 0 twice: once with
the EMA shadows of G (the eval path of record) and once with the raw
weights, and writes both trajectories to one CSV `step,fid_ema,fid_raw`,
rewritten after every checkpoint. Separating the two tells whether the
underlying G gets worse (raw FID degrades, EMA follows with a lag) or only
its EMA copy.

Each view restores the checkpoint into the one TrainState of the run and
fills its own BN accumulators with its own weights: a raw view that reused
the state the EMA view had filled would score the raw G with the EMA's
batch statistics. The two views share that TrainState and the real split's
features (`eval_gan_lib.EvalCache`), which are computed once; they sample
the same z. Neither saves its filled state to `tfhub/<step>`, which stays
the eval schedule's.

Usage (same environment as the training run):
  COMPARE_GAN_DATA_DIR=... COMPARE_GAN_INCEPTION_NPZ=... \
    python -m compare_gan_torch.tools.eval_ema_vs_raw \
      --model_dir=/tmp/biggan128 \
      --gin_config=example_configs/biggan128_polygons_multiclass.gin \
      [--out=/tmp/biggan128/ema_vs_raw.csv] [--device=cuda]
"""

from __future__ import annotations

import argparse
import copy
import csv
import logging
import os
import sys

from compare_gan_torch import checkpoint as ckpt_lib
from compare_gan_torch import eval_gan_lib
from compare_gan_torch.metrics import fid_score

logger = logging.getLogger(__name__)
FIELDS = ["step", "fid_ema", "fid_raw"]


def evaluate_model_dir(gan, model_dir, batch_size=64, out_path=None,
                       num_accu_examples=204800, draw=None, cache=None):
    """FID of every checkpoint in `model_dir` under the EMA and the raw
    params of G. Returns the rows; rewrites `out_path` after every
    checkpoint so an interrupted sweep keeps its rows. `draw` replaces the
    eval draws (tests); `cache` is the `EvalCache` the views share (built
    here when None)."""
    if not gan._g_use_ema:
        raise ValueError("Run trained without g_use_ema; nothing to "
                         "compare.")
    cache = cache if cache is not None else eval_gan_lib.EvalCache()
    if cache.template is None:
        # Build the modules before the copy, so both views own the same.
        cache.template = gan.init_state(0)
    raw_gan = copy.copy(gan)
    raw_gan._g_use_ema = False

    task = fid_score.FIDScoreTask()
    rows = []
    for path in ckpt_lib.all_checkpoints(model_dir):
        step = ckpt_lib.step_of(path)
        if step == 0:
            continue
        row = {"step": step}
        for name, view in (("ema", gan), ("raw", raw_gan)):
            res = eval_gan_lib.evaluate_checkpoint(
                view, path, [task], batch_size=batch_size,
                num_averaging_runs=1, num_accu_examples=num_accu_examples,
                draw=draw, cache=cache, export_accu_checkpoint=False)
            row[f"fid_{name}"] = res["fid_score_mean"]
            logger.info("step %d %s fid=%.4f", step, name,
                        res["fid_score_mean"])
        rows.append(row)
        if out_path is not None:
            with open(out_path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=FIELDS)
                w.writeheader()
                w.writerows(rows)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--gin_config", required=True, nargs="+")
    parser.add_argument("--gin_bindings", default=[], nargs="*")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--out", default=None,
                        help="CSV path (default <model_dir>/ema_vs_raw.csv)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to evaluate on.")
    args = parser.parse_args(argv)

    from compare_gan_torch import config as gin
    from compare_gan_torch import datasets, runner_lib
    from compare_gan_torch import gans  # noqa: F401  (configurables)

    gin.parse_config_files_and_bindings(args.gin_config, args.gin_bindings)
    options = runner_lib.get_options_dict()
    dataset = datasets.get_dataset(seed=547)
    gan = options["gan_class"](dataset=dataset, parameters=options,
                               model_dir=args.model_dir, device=args.device)
    _, num_accu = runner_lib._resolved_eval_settings(eval_tasks=[])
    out_path = args.out or os.path.join(args.model_dir, "ema_vs_raw.csv")
    rows = evaluate_model_dir(gan, args.model_dir,
                              batch_size=args.batch_size, out_path=out_path,
                              num_accu_examples=num_accu)
    print(f"wrote {out_path} ({len(rows)} checkpoints)")
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    sys.exit(main())

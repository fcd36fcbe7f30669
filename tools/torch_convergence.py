#!/usr/bin/env python3
"""An end-to-end convergence run of the PyTorch port on one CUDA card,
and the convergence-proof tools on its model_dir.

    python3 tools/torch_convergence.py --run biggan128 --workdir DIR \
        --out_dir OUT [--training_steps N] [--inception_seed 0]
    python3 tools/torch_convergence.py --run biggan32 ...
    python3 tools/torch_convergence.py --run s3gan_oriented ...
    python3 tools/torch_convergence.py --run ssgan32 ...
    python3 tools/torch_convergence.py --run dcgan28 ...
    python3 tools/torch_convergence.py --run s3gan_partial ...

Runs:

- `biggan128`: example_configs/biggan128_polygons_multiclass.gin as
  published (BigGAN-128 at full width, batch 16, f32, 10,000 steps) on
  `convex_polygons_multiclass_128` (20,000 / 4,000 / 4,000 images,
  seed 0). Then `fid_anchors` (4,000 a split), `tb_scalars` (the loss/*
  tags), `eval_ema_vs_raw` and the demo's per-class grids (on a module
  export of the first and last checkpoints with their filled BN
  accumulators).
- `biggan32`: example_configs/biggan32_polygons_multiclass.gin as
  published (conditional BigGAN-32, batch 64, f32, 8,000 steps, the
  default 204,800-sample accumulator fill) on `convex_polygons_multiclass`
  (60,000 / 10,000 / 10,000 images at 32 px, seed 0). Then the tools of
  `biggan128`.
- `s3gan_oriented`: example_configs/s3gan32_polygons_partial_oriented.gin
  as published (batch 64, 8,000 steps) on
  `convex_polygons_partial_oriented` (60,000 / 10,000 / 10,000, 20% of
  the train labels kept). Then `fid_anchors`, `tb_scalars`,
  `s3gan_predictor_eval` (test split, 2,048 examples), `rotation_probe`
  on `convex_polygons_partial` against `convex_polygons_partial_oriented`,
  the per-class grids and `eval_ema_vs_raw`.
- `ssgan32`: example_configs/ssgan32_polygons_oriented.gin as published
  (SSGAN on ResNet-CIFAR-32, batch 64, 6,000 steps, unconditional, no
  EMA) on `convex_polygons_oriented` (60,000 / 10,000 / 10,000). Then
  `fid_anchors`, `tb_scalars` (with `loss/rotation_accuracy`) and the
  demo's plain grids, `samples_step<step>.png` as the JAX proofs name
  theirs.
- `dcgan28`: example_configs/dcgan_polygons28.gin as published (DCGAN,
  non-saturating loss, batch 64, 10,000 steps, unconditional, no EMA) on
  `convex_polygons` (60,000 / 10,000 / 10,000 triangles at 28 px). Then
  the tools of `ssgan32`.
- `s3gan_partial`: example_configs/s3gan32_polygons_partial.gin as
  published (the degradation case: `s3gan_oriented`'s recipe on the
  rot90-invariant `convex_polygons_partial`). Then the tools of
  `s3gan_oriented`, `eval_ema_vs_raw` last.

Every step goes through the entry points a user calls:
`compare_gan_torch.main.main` with --schedule=eval_after_train
--eval_every_steps=1000 --num_eval_averaging_runs=1, then each tool's
`main(argv)` (what `python -m compare_gan_torch.tools.<name>` runs). The
polygon sets are written by `compare_gan_torch.polygons`; the Inception
network is the port's random-init one from `--inception_seed`, saved as
`.npz` in the work directory and named by $COMPARE_GAN_INCEPTION_NPZ.

Writes to --out_dir the run's scores.csv and the tools' outputs (the files
a convergence proof under docs/ keeps), and `run.json`: the card's name
and power limit, seconds per step (the training phase's wall time over its
steps, and each host-sync loop's), seconds and peak memory of each
checkpoint's eval, the training phase's peak memory, the attention
kernels' launches in training, in the eval schedule and in each tool, and
each phase's seconds. A tool that fails is recorded and the others still
run; the script then exits non-zero.

`--device=cpu` with the size flags below is a dry run of the same code at
a small size (`--gin_bindings` narrows the networks). Imports nothing of
JAX or TensorFlow.
"""

import argparse
import json
import logging
import os
import shutil
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Each run: its config, the dataset it trains on, the polygon sets it
# needs (the trained set first), the loss tags it logs, and
# what its tools need: a conditional G (per-class grids), S3GAN's label
# predictor (the predictor eval and the rotation probe) and an EMA of G
# (eval_ema_vs_raw).
RUNS = {
    "biggan128": {
        "config": "biggan128_polygons_multiclass.gin",
        "dataset": "convex_polygons_multiclass_128",
        "sets": ["convex_polygons_multiclass_128"],
        "loss_tags": ["loss/d_0", "loss/d_1", "loss/g", "loss/penalty"],
        "conditional": True, "predictor": False, "ema": True,
    },
    "biggan32": {
        "config": "biggan32_polygons_multiclass.gin",
        "dataset": "convex_polygons_multiclass",
        "sets": ["convex_polygons_multiclass"],
        "loss_tags": ["loss/d_0", "loss/d_1", "loss/g", "loss/penalty"],
        "conditional": True, "predictor": False, "ema": True,
    },
    "s3gan_oriented": {
        "config": "s3gan32_polygons_partial_oriented.gin",
        "dataset": "convex_polygons_partial_oriented",
        "sets": ["convex_polygons_partial_oriented",
                 "convex_polygons_partial"],
        "loss_tags": ["loss/d_0", "loss/d_1", "loss/g",
                      "loss/class_loss_real",
                      "loss/rotation_accuracy_real"],
        "conditional": True, "predictor": True, "ema": True,
    },
    "ssgan32": {
        "config": "ssgan32_polygons_oriented.gin",
        "dataset": "convex_polygons_oriented",
        "sets": ["convex_polygons_oriented"],
        "loss_tags": ["loss/d_0", "loss/d_1", "loss/g",
                      "loss/c_real_loss", "loss/c_fake_loss",
                      "loss/rotation_accuracy"],
        "conditional": False, "predictor": False, "ema": False,
    },
    "dcgan28": {
        "config": "dcgan_polygons28.gin",
        "dataset": "convex_polygons",
        "sets": ["convex_polygons"],
        "loss_tags": ["loss/d_0", "loss/g", "loss/penalty"],
        "conditional": False, "predictor": False, "ema": False,
    },
    "s3gan_partial": {
        "config": "s3gan32_polygons_partial.gin",
        "dataset": "convex_polygons_partial",
        "sets": ["convex_polygons_partial",
                 "convex_polygons_partial_oriented"],
        "loss_tags": ["loss/d_0", "loss/d_1", "loss/g",
                      "loss/class_loss_real",
                      "loss/rotation_accuracy_real"],
        "conditional": True, "predictor": True, "ema": True,
    },
}
# The rotation probe's two sets: rot90-invariant and oriented.
PROBE_SETS = ("convex_polygons_partial", "convex_polygons_partial_oriented")


def _card(device):
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return smi.stdout.strip()


def write_datasets(run, data_dir, sizes, workers):
    """The run's polygon set(s) at their writers' default sizes (or
    `sizes` = (train, test, holdout)), seed 0; a set already in `data_dir`
    is kept."""
    from compare_gan_torch import polygons
    kwargs = dict(n_workers=workers)
    if sizes:
        kwargs.update(zip(("n_train", "n_test", "n_holdout"), sizes))
    for name in RUNS[run]["sets"]:
        if not all(os.path.exists(os.path.join(data_dir, name, f"{split}.npz"))
                   for split in ("train", "test", "holdout")):
            polygons.WRITERS[name](data_dir, **kwargs)


class Launches:
    """The attention kernels' launch counters, read and reset."""

    def __init__(self):
        from compare_gan_torch.ops import fused_attention
        self._fa = fused_attention

    def take(self):
        out = {"fwd": self._fa.launches_fwd, "bwd": self._fa.launches_bwd}
        self._fa.launches_fwd = self._fa.launches_bwd = 0
        return out


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_schedule(torch, args, device, model_dir, record):
    """eval_after_train through the CLI; the training phase's seconds,
    peak memory and launches come from its report."""
    from compare_gan_torch import config as gin
    from compare_gan_torch import main
    launches = Launches()
    config = os.path.join(ROOT, "example_configs", RUNS[args.run]["config"])
    argv = [f"--model_dir={model_dir}", "--schedule=eval_after_train",
            f"--eval_every_steps={args.eval_every_steps}",
            "--num_eval_averaging_runs=1", f"--device={device}",
            f"--gin_config={config}"]
    bindings = list(args.gin_bindings)
    if args.training_steps:
        bindings.append(f"options.training_steps = {args.training_steps}")
    argv += [f"--gin_bindings={b}" for b in bindings]
    gin.clear_config()
    launches.take()
    t0 = time.perf_counter()
    report = main.main(argv)
    _sync(torch, device)
    record["schedule_seconds"] = time.perf_counter() - t0
    record["train_seconds"] = report.train_seconds
    record["train_peak_GiB"] = report.train_peak_bytes / 2 ** 30
    record["train_launches"] = report.train_launches
    total = launches.take()
    record["eval_launches"] = {k: n - report.train_launches.get(k, 0)
                               for k, n in total.items()}
    steps = report.steps[-1]
    loops = [b - a for a, b in zip([0] + report.steps[:-1], report.steps)]
    record["training_steps"] = steps
    record["seconds_per_step_wall"] = record["train_seconds"] / steps
    record["seconds_per_step_loops"] = report.seconds_per_step
    record["seconds_per_step_in_loops"] = sum(
        s * n for s, n in zip(report.seconds_per_step, loops)) / steps
    record["losses_last"] = report.metrics[-1]
    record["evals"] = [{
        "step": e["step"], "seconds": e["seconds"],
        "total_seconds": sum(e["seconds"].values()),
        "peak_GiB": max(e["peak_bytes"].values(), default=0) / 2 ** 30,
        "results": {k: v for k, v in e["results"].items()
                    if k.endswith("_mean")}} for e in report.evals]
    for e in record["evals"]:
        print(f"eval step {e['step']}: {e['results']} in "
              f"{e['total_seconds']:.1f} s, peak {e['peak_GiB']:.2f} GiB",
              flush=True)


def filled_export(config, gin_bindings, model_dir, step, device):
    """A module export of checkpoint `step` holding the BN accumulators
    its eval filled (`tfhub/<step>/model.ckpt-<step>.npz`), for the demo.
    The eval schedule's own export, `tfhub/<step>`, is written before the
    fill, as the JAX package writes it: its accumulators are the training
    state's (count 1e-12), so G in eval mode divides every BN input by
    sqrt(epsilon). Without a filled checkpoint (no accumulators) that
    export is returned."""
    from compare_gan_torch import checkpoint as ckpt_lib
    from compare_gan_torch import config as gin
    from compare_gan_torch import datasets, export, runner_lib
    from compare_gan_torch import gans  # noqa: F401  (configurables)
    filled = os.path.join(model_dir, "tfhub", str(step),
                          f"model.ckpt-{step}.npz")
    if not os.path.exists(filled):
        return os.path.join(model_dir, "tfhub", str(step))
    gin.clear_config()
    gin.parse_config_files_and_bindings([config], gin_bindings)
    options = runner_lib.get_options_dict()
    gan = options["gan_class"](dataset=datasets.get_dataset(seed=547),
                               parameters=options, model_dir=model_dir,
                               device=device)
    ts = ckpt_lib.restore_checkpoint(filled, gan.init_state(0))
    return export.export_module(
        gan, ts, os.path.join(model_dir, f"filled_export_{step}"))


def run_tools(torch, args, device, model_dir, out_dir, record):
    from compare_gan_torch import checkpoint as ckpt_lib
    from compare_gan_torch import config as gin
    from compare_gan_torch import demo
    from compare_gan_torch.tools import (
        eval_ema_vs_raw, fid_anchors, rotation_probe, s3gan_predictor_eval,
        tb_scalars)
    spec = RUNS[args.run]
    config = os.path.join(ROOT, "example_configs", spec["config"])
    bindings = (["--gin_bindings", *args.gin_bindings]
                if args.gin_bindings else [])
    record["tools"] = {}
    launches = Launches()

    def tool(name, fn, argv):
        """One tool's main(argv), timed, its launches counted; a failure
        is recorded and the next tool runs."""
        gin.clear_config()
        launches.take()
        t0 = time.perf_counter()
        entry = record["tools"][name] = {}
        try:
            out = fn(argv + [f"--device={device}"])
            if name in ("fid_anchors", "rotation_probe"):
                entry["result"] = out
        except Exception:  # Recorded; the script exits non-zero.
            entry["error"] = traceback.format_exc()
            print(entry["error"], flush=True)
        _sync(torch, device)
        entry["seconds"] = time.perf_counter() - t0
        entry["launches"] = launches.take()
        print(f"tool {name}: seconds {entry['seconds']:.2f} launches "
              f"{entry['launches']}", flush=True)
        save_record(out_dir, record)

    tool("fid_anchors", fid_anchors.main, [
        f"--dataset={spec['dataset']}",
        f"--max_per_split={args.anchor_per_split}",
        f"--out={os.path.join(out_dir, 'anchors.json')}"])
    # tb_scalars reads no network: its argv takes no --device.
    tool("tb_scalars", lambda argv: tb_scalars.main(argv[:-1]), [
        f"--model_dir={model_dir}",
        f"--out_dir={os.path.join(out_dir, 'loss_traces')}",
        "--tags", *spec["loss_tags"]])
    record["events_match_jsonl"] = tb_scalars.forms_agree(model_dir)[0]
    if spec["predictor"]:
        tool("s3gan_predictor_eval", s3gan_predictor_eval.main, [
            f"--model_dir={model_dir}", "--gin_config", config, *bindings,
            f"--num_examples={args.predictor_examples}",
            f"--out_csv={os.path.join(out_dir, 'predictor_accuracy.csv')}"])
        tool("rotation_probe", rotation_probe.main, [
            "--datasets", *PROBE_SETS, f"--steps={args.probe_steps}",
            f"--out={os.path.join(out_dir, 'rotation_probe.json')}"])
    steps = [ckpt_lib.step_of(p) for p in ckpt_lib.all_checkpoints(model_dir)]
    exported = [s for s in steps if os.path.isdir(
        os.path.join(model_dir, "tfhub", str(s)))]
    # A conditional G gets a row per class; an unconditional one the
    # demo's plain grid, named as the JAX proofs name theirs.
    grid_flag = ["--per_class_grid"] if spec["conditional"] else []
    samples = "samples_per_class" if spec["conditional"] else "samples"
    for step in sorted({exported[0], exported[-1]} if exported else ()):
        grid_dir = os.path.join(model_dir, f"demo_{step}")
        export_dir = filled_export(config, args.gin_bindings, model_dir,
                                   step, device)
        tool(f"demo_{step}", demo.main, [
            f"--export_dir={export_dir}", f"--out_dir={grid_dir}",
            *grid_flag])
        for name, kept in (("samples", samples),
                           ("interpolation", "interpolation")):
            path = os.path.join(grid_dir, f"{name}.png")
            if os.path.exists(path):
                shutil.copy(path, os.path.join(
                    out_dir, f"{kept}_step{step:05d}.png"))
    if spec["ema"]:
        # The longest tool last: its CSV is rewritten after every
        # checkpoint, so a cut run keeps the rows done.
        tool("eval_ema_vs_raw", eval_ema_vs_raw.main, [
            f"--model_dir={model_dir}", "--gin_config", config, *bindings,
            f"--out={os.path.join(out_dir, 'ema_vs_raw.csv')}"])


def save_record(out_dir, record):
    with open(os.path.join(out_dir, "run.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--run", choices=sorted(RUNS), required=True)
    p.add_argument("--workdir", required=True,
                   help="Data, Inception weights and the model_dir.")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--training_steps", type=int, default=None,
                   help="Cut options.training_steps (default: the "
                   "config's).")
    p.add_argument("--inception_seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--gin_bindings", action="append", default=[],
                   help="Further bindings of the run and its tools.")
    p.add_argument("--dataset_sizes", default=None,
                   help="train,test,holdout (default: the writers').")
    p.add_argument("--polygon_workers", type=int, default=8,
                   help="Rasterizer threads for the polygon sets (0: "
                   "serial).")
    p.add_argument("--eval_every_steps", type=int, default=1000)
    p.add_argument("--anchor_per_split", type=int, default=4000)
    p.add_argument("--predictor_examples", type=int, default=2048)
    p.add_argument("--probe_steps", type=int, default=400)
    p.add_argument("--eval_test_samples", type=int, default=None,
                   help="Cut the dataset's eval split size (dry runs).")
    args = p.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_convergence: no CUDA device.")
    from compare_gan_torch import datasets, eval_utils
    from compare_gan_torch.metrics import inception_net

    record = {"run": args.run, "card": _card(device), "args": vars(args),
              "phase_seconds": {}}
    print(record["card"], flush=True)
    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.perf_counter()
    data_dir = os.path.join(args.workdir, "data")
    sizes = ([int(x) for x in args.dataset_sizes.split(",")]
             if args.dataset_sizes else None)
    write_datasets(args.run, data_dir, sizes, args.polygon_workers)
    os.environ["COMPARE_GAN_DATA_DIR"] = datasets.DATA_DIR = data_dir
    if args.eval_test_samples:
        datasets.cut_eval_split(RUNS[args.run]["dataset"],
                                args.eval_test_samples)
    npz = os.path.join(args.workdir, "inception_random.npz")
    np.savez(npz, **inception_net.init_random(
        torch.Generator().manual_seed(args.inception_seed)))
    os.environ[eval_utils.INCEPTION_NPZ_ENV] = npz
    record["phase_seconds"]["setup"] = time.perf_counter() - t0

    model_dir = os.path.join(args.workdir, args.run)
    try:
        t0 = time.perf_counter()
        run_schedule(torch, args, device, model_dir, record)
        record["phase_seconds"]["schedule"] = time.perf_counter() - t0
        scores = os.path.join(model_dir, "scores.csv")
        if os.path.exists(scores):  # No checkpoint at the eval cadence.
            shutil.copy(scores, args.out_dir)
        save_record(args.out_dir, record)
        t0 = time.perf_counter()
        run_tools(torch, args, device, model_dir, args.out_dir, record)
        record["phase_seconds"]["tools"] = time.perf_counter() - t0
    finally:
        save_record(args.out_dir, record)
    print("run " + json.dumps({k: v for k, v in record.items()
                               if k != "seconds_per_step_loops"},
                              default=str))
    failed = [k for k, v in record["tools"].items() if "error" in v]
    if failed or not record["events_match_jsonl"]:
        raise SystemExit(f"torch_convergence: tools failed {failed}, "
                         f"events match JSONL "
                         f"{record['events_match_jsonl']}")


if __name__ == "__main__":
    main()

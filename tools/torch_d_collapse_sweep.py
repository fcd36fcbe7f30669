#!/usr/bin/env python3
"""BigGAN-128's first steps on a CUDA card, for several seeds under one
variant of the card's numerics: does D's hinge loss collapse to 0?

    python3 tools/torch_d_collapse_sweep.py --variant plain_attention \
        --seeds default,1,2,3 --workdir /tmp/w \
        --out_dir docs/convergence_torch_biggan128/collapse_sweep

Each run is `python -m compare_gan_torch.main --schedule=train` on
example_configs/biggan128_polygons_multiclass.gin as published, with the
seed sweep's bindings: `options.training_steps` (`--steps`, 500),
`run_config.iterations_per_loop` (`--loop`, 50), no checkpoint before the
last, and `run_config.tf_random_seed` unless the seed is `default`. Each
run is a process of its own (this script with `--child`), which sets the
variant up and then calls the CLI's `main`:

- `published`: nothing changed.
- `plain_attention`: the non-local block's attention runs through
  `reference_attention` on the CUDA tensors (the dispatch in
  `fused_attention.fused_attention`), not through the kernels.
- `tf32_off_deterministic`: `NVIDIA_TF32_OVERRIDE=0` in the run's
  environment, `allow_tf32` off for cuDNN and cuBLAS and
  `torch.backends.cudnn.deterministic = True` (benchmark off).

`--ch` (a list) binds `resnet_biggan.{Generator,Discriminator}.ch`; each
width runs every seed. The config's polygon set
(`convex_polygons_multiclass_128`, or the 32-px `convex_polygons_multiclass`
of `--gin_config` biggan32_polygons_multiclass.gin; seed 0) is written
into `--workdir` at `--n_train` training images when it is not there.

Writes `<out_dir>/<name>.csv` (`--name`, default the variant): one row a
loop of every run, with the loop's mean D and G losses, the run's first
loop whose two D losses are both exactly 0, its seconds per step (the
loops after the first), the card line (`nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`) and the command; and
`<name>.json` with the same per run plus a digest of the final weights
(two runs of one seed that repeat bitwise have the same digest). Imports
nothing of JAX.
"""

import argparse
import csv
import hashlib
import json
import os
import shlex
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "example_configs",
                      "biggan128_polygons_multiclass.gin")
VARIANTS = ("published", "plain_attention", "tf32_off_deterministic")
LOSSES = ("loss/d_0", "loss/d_1", "loss/g")


def card_line():
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, IndexError):
        return "cpu"


def write_polygon_set(name, data_dir, n_train, n_eval, workers):
    """The polygon set `name` (seed 0) with `n_train` training and `n_eval`
    test and holdout images, unless `data_dir` holds it already."""
    from compare_gan_torch import polygons
    if os.path.exists(os.path.join(data_dir, name, "train.npz")):
        return
    polygons.WRITERS[name](data_dir, n_train=n_train, n_test=n_eval,
                           n_holdout=n_eval, n_workers=workers)


def cli_argv(model_dir, seed, ch, args):
    """The CLI's argv of one run."""
    bindings = [f"options.training_steps = {args.steps}",
                f"run_config.iterations_per_loop = {args.loop}",
                "run_config.save_checkpoints_steps = 100000"]
    if seed != "default":
        bindings.append(f"run_config.tf_random_seed = {int(seed)}")
    if ch:
        bindings += [f"resnet_biggan.Generator.ch = {ch}",
                     f"resnet_biggan.Discriminator.ch = {ch}"]
    bindings += args.gin_bindings
    return ([f"--model_dir={model_dir}", "--schedule=train",
             f"--gin_config={args.gin_config}", f"--device={args.device}"]
            + [f"--gin_bindings={b}" for b in bindings])


def set_up_variant(variant):
    """In the child, before the CLI runs."""
    import torch
    if variant == "plain_attention":
        from compare_gan_torch.ops import fused_attention
        fused_attention.fused_attention = fused_attention.reference_attention
    elif variant == "tf32_off_deterministic":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False


def state_digest(ts):
    """sha256 of every parameter and state tensor of a TrainState, by
    name."""
    from compare_gan_torch import interop
    h = hashlib.sha256()
    for name, t in sorted(interop.state_dict(ts).items()):
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def child(args, cli):
    """One run: the variant, then the CLI's main; its report as JSON."""
    sys.path.insert(0, ROOT)
    set_up_variant(args.variant)
    from compare_gan_torch import main as cli_main
    from compare_gan_torch.ops import fused_attention
    report = cli_main.main(cli)
    out = {"steps": report.steps, "metrics": report.metrics,
           "seconds_per_step": report.seconds_per_step,
           "train_seconds": report.train_seconds,
           "launches": {"fwd": fused_attention.launches_fwd,
                        "bwd": fused_attention.launches_bwd},
           "digest": state_digest(report.state)}
    with open(args.child_out, "w") as f:
        json.dump(out, f)


def first_zero_loop(steps, metrics):
    for step, m in zip(steps, metrics):
        if m["loss/d_0"] == 0.0 and m["loss/d_1"] == 0.0:
            return step
    return None


def run_sweep(args):
    sys.path.insert(0, ROOT)
    from compare_gan_torch import config as gin
    gin.clear_config()
    gin.parse_config_files_and_bindings([args.gin_config], [])
    data_dir = os.path.join(args.workdir, "data")
    t0 = time.perf_counter()
    write_polygon_set(gin.query("dataset.name"), data_dir, args.n_train,
                      args.n_eval, args.polygon_workers)
    setup_seconds = time.perf_counter() - t0
    card = card_line()
    print(card, flush=True)
    env = dict(os.environ, COMPARE_GAN_DATA_DIR=data_dir)
    if args.variant == "tf32_off_deterministic":
        env["NVIDIA_TF32_OVERRIDE"] = "0"
    os.makedirs(args.out_dir, exist_ok=True)
    name = args.name or args.variant
    widths = [int(c) for c in args.ch.split(",")] if args.ch else [None]
    seeds = args.seeds.split(",")
    rows, runs = [], []
    for ch in widths:
        for i, seed in enumerate(seeds):
            model_dir = os.path.join(args.workdir, f"{name}_{ch}_{i}")
            shutil.rmtree(model_dir, ignore_errors=True)
            cli = cli_argv(model_dir, seed, ch, args)
            child_out = model_dir + ".json"
            cmd = [sys.executable, os.path.abspath(__file__), "--child",
                   f"--variant={args.variant}", f"--child_out={child_out}",
                   "--", *cli]
            shown = ("python -m compare_gan_torch.main "
                     + " ".join(shlex.quote(a) for a in cli))
            print(f"run {name} ch {ch} seed {seed}: {shown}", flush=True)
            t0 = time.perf_counter()
            rc = subprocess.run(cmd, env=env, cwd=ROOT).returncode
            wall = time.perf_counter() - t0
            if rc:
                raise SystemExit(f"torch_d_collapse_sweep: run {seed} at ch "
                                 f"{ch} exited {rc}.")
            with open(child_out) as f:
                rep = json.load(f)
            shutil.rmtree(model_dir, ignore_errors=True)
            zero = first_zero_loop(rep["steps"], rep["metrics"])
            loops = rep["seconds_per_step"][1:] or rep["seconds_per_step"]
            s_step = sum(loops) / len(loops)
            run = {"variant": args.variant, "ch": ch or 96, "seed": seed,
                   "run": i, "first_zero_loop": zero,
                   "zero_loops": sum(m["loss/d_0"] == 0 == m["loss/d_1"]
                                     for m in rep["metrics"]),
                   "s_per_step": s_step, "wall_seconds": wall,
                   "train_seconds": rep["train_seconds"],
                   "launches": rep["launches"], "digest": rep["digest"],
                   "command": shown, "card": card}
            runs.append(dict(run, losses=[
                {"step": s, **{k[5:]: m[k] for k in LOSSES}}
                for s, m in zip(rep["steps"], rep["metrics"])]))
            for s, m in zip(rep["steps"], rep["metrics"]):
                rows.append({"variant": args.variant, "ch": run["ch"],
                             "seed": seed, "run": i, "step": s,
                             **{k[5:]: repr(m[k]) for k in LOSSES},
                             "first_zero_loop": zero,
                             "s_per_step": f"{s_step:.4f}", "card": card,
                             "command": shown})
            print(f"run {name} ch {ch} seed {seed}: first zero loop {zero}, "
                  f"{s_step:.4f} s/step, d_0 by loop "
                  + " ".join(f"{m['loss/d_0']:.4g}" for m in rep["metrics"]),
                  flush=True)
            write(args.out_dir, name, rows, runs, setup_seconds)
    collapsed = sum(r["first_zero_loop"] is not None for r in runs)
    print(f"sweep {name}: {collapsed} of {len(runs)} runs collapsed",
          flush=True)


def write(out_dir, name, rows, runs, setup_seconds):
    with open(os.path.join(out_dir, f"{name}.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump({"setup_seconds": setup_seconds, "runs": runs,
                   "collapsed": sum(r["first_zero_loop"] is not None
                                    for r in runs)}, f, indent=1)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cli = []
    if "--" in argv:
        cli = argv[argv.index("--") + 1:]
        argv = argv[:argv.index("--")]
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--variant", choices=VARIANTS, default="published")
    p.add_argument("--seeds", default="default,1,2,3",
                   help="`default` (the config's seed 547) or an integer "
                   "run_config.tf_random_seed; a seed may repeat.")
    p.add_argument("--ch", default=None, help="Widths, e.g. 16,32,48.")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--loop", type=int, default=50)
    p.add_argument("--workdir", default=None)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--name", default=None)
    p.add_argument("--gin_config", default=CONFIG)
    p.add_argument("--gin_bindings", action="append", default=[])
    p.add_argument("--device", default="cuda")
    p.add_argument("--n_train", type=int, default=20000)
    p.add_argument("--n_eval", type=int, default=4000)
    p.add_argument("--polygon_workers", type=int, default=8)
    p.add_argument("--child", action="store_true")
    p.add_argument("--child_out", default=None)
    args = p.parse_args(argv)
    if args.child:
        return child(args, cli)
    if not (args.workdir and args.out_dir):
        p.error("--workdir and --out_dir are required.")
    return run_sweep(args)


if __name__ == "__main__":
    main()

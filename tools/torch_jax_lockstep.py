#!/usr/bin/env python3
"""The PyTorch port beside the JAX package on the CPU: their inits at a
given width, and their train steps in lockstep on the same polygon
batches.

    # Inits and first forwards, three seeds each (CPU only):
    python3 tools/torch_jax_lockstep.py --mode init --ch 96 --batch 16 \
        --seeds 0,1,2 --workdir /tmp/w --out_dir OUT
    # Both packages from JAX's init, same batches and JAX's draws:
    python3 tools/torch_jax_lockstep.py --mode lockstep --ch 16 \
        --steps 300 --workdir /tmp/w --out_dir OUT

Both modes read `--gin_config` (default
example_configs/biggan128_polygons_multiclass.gin) with `ch` bound for G
and D, and the extra `--gin_bindings`. The data is the
config's polygon set, written by `compare_gan_torch.polygons` into
`--workdir` at `--n_train` images (seed 0) when it is not there. Both
packages run in f32; the JAX package's attention runs through its plain
einsum (its CPU default), the port's through `reference_attention`.

`--mode init` builds G and D three ways for each seed: the JAX package's
`init_state`, the port's own `init_state`, and the port loaded from the
JAX init through `interop`. It writes `init_layers.csv`: per variable and
statistic (its std, and its mean unless it is a kernel; for a
spectral-normed kernel the sigma of the first forward's power iteration
from the initial `u`, and the true largest singular value) the mean and
range over the seeds for JAX and the port, and `finding` where the two
means differ by more than the larger range and by more than f32
rounding. `init_forward.csv` holds, per init and seed, G's output
statistics, D's logits on one real batch and on the fakes, and the first
D hinge loss, from the same z and labels.

`--mode lockstep` starts both packages from the JAX init (seed
`--seeds`' first), feeds both the same batches and, each step, the JAX
package's own z and sampled labels (the port step's `draws=`), and
writes `lockstep.csv` (each step's D and G losses of both, their largest
relative gap) and `lockstep.json`: the first step at which a loss parts
by more than 1e-3 relative, and the first step at which each
package's D losses are all exactly 0. With `--control_gin_bindings` a
second port, those bindings on top, runs beside them from the same init
on the same inputs (a port made to differ, e.g. in D's learning rate,
which must part at once), with its own columns and parting step.

Any polygon-set config runs; `--ch` binds only BigGAN's widths. DCGAN-28
at its published batch (`--gin_config
example_configs/dcgan_polygons28.gin --batch 64`) takes ~3.5 s a step.

Imports both packages; runs on the CPU only.
"""

import argparse
import csv
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CONFIG = os.path.join(ROOT, "example_configs",
                              "biggan128_polygons_multiclass.gin")
# The losses compared, those of them the config logs (one D loss a D
# sub-step: `loss/d_1` only with disc_iters 2).
LOSSES = ("loss/d_0", "loss/d_1", "loss/g")
# A statistic's gap between the packages' inits below this is f32
# rounding, whatever the seeds' spread (an orthogonal kernel's sigma is 1
# to ~1e-7 in either package).
RTOL_FLOOR, ATOL_FLOOR = 1e-4, 1e-6
# Two losses "part" when they differ by more than this, relative.
PART_RTOL = 1e-3


def _bindings(args, extra=()):
    return [f"resnet_biggan.Generator.ch = {args.ch}",
            f"resnet_biggan.Discriminator.ch = {args.ch}",
            f"options.batch_size = {args.batch}", *args.gin_bindings,
            *extra]


def build_port(args, extra=()):
    """(tgan, batch_size): the port's GAN of the config with `extra`
    bindings on top; the data set is written if it is missing. Its gin
    stays parsed."""
    from compare_gan_torch import config as tgin
    from compare_gan_torch import datasets, runner_lib
    from compare_gan_torch.gans import modular_gan  # noqa: F401
    from tools.torch_d_collapse_sweep import write_polygon_set

    data_dir = os.path.join(args.workdir, "data")
    datasets.DATA_DIR = data_dir
    tgin.clear_config()
    tgin.parse_config_files_and_bindings([args.gin_config],
                                         _bindings(args, extra))
    options = runner_lib.get_options_dict()
    write_polygon_set(tgin.query("dataset.name"), data_dir, args.n_train,
                      args.batch, args.polygon_workers)
    tgan = options["gan_class"](
        dataset=datasets.get_dataset(seed=547), parameters=options,
        model_dir="unused", device="cpu")
    return tgan, options["batch_size"]


def build_jax(args):
    """The JAX package's GAN of the config."""
    from compare_gan_tpu import config as jgin
    from compare_gan_tpu import datasets as jdatasets
    from compare_gan_tpu import runner_lib as jrunner
    from compare_gan_tpu.gans import modular_gan as jmodular  # noqa: F401

    jdatasets.DATA_DIR = os.path.join(args.workdir, "data")
    jgin.clear_config()
    jgin.parse_config_files_and_bindings(
        [args.gin_config], _bindings(args) + ["attention.use_pallas = False"])
    joptions = jrunner.get_options_dict()
    return joptions["gan_class"](
        dataset=jdatasets.get_dataset(seed=547), parameters=joptions,
        model_dir="unused")


def build(args):
    """(jgan, tgan, batch_size): both packages' GANs of the config."""
    tgan, batch_size = build_port(args)
    return build_jax(args), tgan, batch_size


def jax_init(jgan):
    """seed -> the JAX package's TrainState, compiled once."""
    import jax
    init = jax.jit(lambda key: jgan.init_state(key, 2))
    return lambda seed: init(jax.random.PRNGKey(seed))


def port_from_jax(tgan, ts_j, seed=0):
    """The port's TrainState holding the JAX TrainState's variables."""
    from compare_gan_torch import interop
    ts = tgan.init_state(seed)
    interop.load_state_dict(ts, interop.params_from_jax(
        ts_j.params, ts_j.state, ts_j.ema_params))
    return ts


def jax_layout(ts):
    """({name: params}, {name: state}) as float64 numpy in the JAX
    layout, of either package's TrainState."""
    if hasattr(ts, "rng"):  # The JAX package's.
        return ({k: np.asarray(v, np.float64) for k, v in ts.params.items()},
                {k: np.asarray(v, np.float64) for k, v in ts.state.items()})
    from compare_gan_torch import interop
    params, state, _ = interop.params_to_jax(interop.state_dict(ts))
    return ({k: np.asarray(v, np.float64) for k, v in params.items()},
            {k: np.asarray(v, np.float64) for k, v in state.items()})


def _unit(x):
    return x / max(np.linalg.norm(x), 1e-12)


def layer_stats(params, state):
    """{(variable, statistic): value}: every variable's std, and the mean
    of each that is not a kernel (biases, gains, attention gates); for a
    kernel
    with spectral norm (`<kernel>/u_var` in the state) the first
    forward's sigma (one power iteration from the initial u, as
    `spectral_norm_sigma`) and its largest singular value (50 iterations
    from there)."""
    out = {}
    for name, w in params.items():
        if not name.endswith("kernel"):  # A kernel's mean is ~0 noise.
            out[name, "mean"] = float(w.mean())
        if w.size > 1:
            out[name, "std"] = float(w.std())
        u = state.get(name + "/u_var")
        if u is None:
            continue
        w2 = w.reshape(-1, w.shape[-1])
        if u.shape != (w2.shape[0], 1):  # "right": on the transpose.
            w2, u = w2.T, u.T
        v = _unit(w2.T @ u)
        t = w2 @ v
        out[name, "sigma_first"] = float(np.linalg.norm(t))
        for _ in range(50):
            v = _unit(w2.T @ _unit(t))
            t = w2 @ v
        out[name, "sigma_true"] = float(np.linalg.norm(t))
    return out


def first_inputs(tgan, batch_size, seed):
    """One real batch of the config's data set, and z and sampled labels
    from numpy."""
    batch = next(iter(tgan.input_batches(batch_size)))
    rng = np.random.RandomState(seed)
    return {"images": batch["images"][:batch_size],
            "labels": batch["labels"][:batch_size].astype(np.int32),
            "z": rng.randn(batch_size, tgan.z_dim).astype(np.float32),
            "sampled_labels": rng.randint(
                0, tgan._dataset.num_classes, batch_size).astype(np.int32)}


def _forward_stats(fake, logits):
    fake, logits = np.asarray(fake, np.float64), np.asarray(
        logits, np.float64).reshape(-1)
    real, fake_l = np.split(logits, 2)
    d_loss = (np.maximum(0, 1 - real).mean()
              + np.maximum(0, 1 + fake_l).mean())
    return {"g_mean": fake.mean(), "g_std": fake.std(), "g_min": fake.min(),
            "g_max": fake.max(), "logit_real_mean": real.mean(),
            "logit_real_std": real.std(), "logit_fake_mean": fake_l.mean(),
            "logit_fake_std": fake_l.std(),
            "logit_abs_max": np.abs(logits).max(), "d_hinge_loss": d_loss}


def jax_forward(jgan):
    """A jitted (params, state, inputs) -> (fake, D logits on real+fake),
    training mode, committing nothing."""
    import jax
    import jax.numpy as jnp
    from compare_gan_tpu import core as jcore

    def fwd(params, state, x):
        def net():
            ys = jgan._get_one_hot_labels(x["sampled_labels"])
            y = jgan._get_one_hot_labels(x["labels"])
            fake = jgan.generator(x["z"], y=ys, is_training=True)
            _, logits, _ = jgan.discriminator(
                jnp.concatenate([x["images"], fake]),
                y=jnp.concatenate([y, ys]), is_training=True)
            return fake, logits
        return jcore.apply(net, params, state)[0]
    return jax.jit(fwd)


def port_forward(tgan, ts, x):
    import torch
    from compare_gan_torch import core
    with torch.no_grad(), core.no_state_updates():
        ys = tgan._get_one_hot_labels(torch.from_numpy(x["sampled_labels"]))
        y = tgan._get_one_hot_labels(torch.from_numpy(x["labels"]))
        fake = ts.generator(torch.from_numpy(x["z"]), y=ys, is_training=True)
        _, logits, _ = ts.discriminator(
            torch.cat([torch.from_numpy(x["images"]), fake]),
            y=torch.cat([y, ys]), is_training=True)
    return fake.numpy(), logits.numpy()


def run_init(args):
    jgan, tgan, batch_size = build(args)
    seeds = [int(s) for s in args.seeds.split(",")]
    x = first_inputs(tgan, batch_size, seed=1234)
    jfwd = jax_forward(jgan)
    jinit = jax_init(jgan)
    layers = {"jax": [], "port": []}
    forward_rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        ts_j = jinit(seed)
        inits = {"jax": ts_j, "port": tgan.init_state(seed)}
        for which, ts in inits.items():
            layers[which].append(layer_stats(*jax_layout(ts)))
        stats = {"jax": _forward_stats(*jfwd(ts_j.params, ts_j.state, x)),
                 "port": _forward_stats(*port_forward(tgan, inits["port"],
                                                      x))}
        del inits
        stats["port_from_jax"] = _forward_stats(*port_forward(
            tgan, port_from_jax(tgan, ts_j, seed), x))
        for which, s in stats.items():
            forward_rows.append({"init": which, "seed": seed, **s})
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s; "
              + "; ".join(f"{w} D loss {s['d_hinge_loss']:.4f} |logit| max "
                          f"{s['logit_abs_max']:.3f}"
                          for w, s in stats.items()), flush=True)
    rows = []
    for key in layers["jax"][0]:
        j = np.array([s[key] for s in layers["jax"]])
        p = np.array([s[key] for s in layers["port"]])
        spread = max(np.ptp(j), np.ptp(p))
        gap = abs(p.mean() - j.mean())
        rows.append({"variable": key[0], "statistic": key[1],
                     "jax_mean": j.mean(), "jax_range": np.ptp(j),
                     "port_mean": p.mean(), "port_range": np.ptp(p),
                     "rel_gap": gap / max(abs(j.mean()), 1e-12),
                     # Above the seeds' spread and above f32 rounding.
                     "finding": int(gap > spread and gap > RTOL_FLOOR
                                    * max(abs(j.mean()), abs(p.mean()))
                                    + ATOL_FLOOR)})
    os.makedirs(args.out_dir, exist_ok=True)
    _write_csv(os.path.join(args.out_dir, "init_layers.csv"), rows)
    _write_csv(os.path.join(args.out_dir, "init_forward.csv"), forward_rows)
    findings = [(r["variable"], r["statistic"]) for r in rows
                if r["finding"]]
    summary = {"ch": args.ch, "batch": batch_size, "seeds": seeds,
               "variables": len(layers["jax"][0]), "findings": findings}
    with open(os.path.join(args.out_dir, "init.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print("init " + json.dumps(summary))
    return summary


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def parted(a, b, rtol=PART_RTOL, atol=1e-6):
    return abs(a - b) > rtol * max(abs(a), abs(b)) + atol


def run_lockstep(args):
    import jax
    from tests import torch_helpers as th
    import torch
    torch.set_num_threads(args.threads)  # torch_helpers pins one.
    jgan = build_jax(args)
    seed = int(args.seeds.split(",")[0])
    ts_j = jax_init(jgan)(seed)
    # The control is built first: the port's own config stays parsed.
    who = (["control"] if args.control_gin_bindings else []) + ["port"]
    ports = {}
    for name in who:
        tgan, batch_size = build_port(
            args, args.control_gin_bindings if name == "control" else ())
        ts = port_from_jax(tgan, ts_j, seed)
        ports[name] = [tgan.make_train_step(batch_size), ts]
    step_j = jax.jit(jgan.make_train_step(batch_size))
    batches = tgan.input_batches(batch_size)
    rows, summary = [], {
        "ch": args.ch, "batch": batch_size, "seed": seed,
        "control_gin_bindings": args.control_gin_bindings,
        **{f"{w}_first_parting": None for w in who},
        **{f"{w}_d_zero": None for w in ["jax"] + who}}
    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.perf_counter()
    for step in range(1, args.steps + 1):
        batch = next(batches)
        batch = {"images": batch["images"],
                 "labels": batch["labels"].astype(np.int32)}
        draws = th.jax_draws(jgan, ts_j, batch["labels"], batch_size)
        ts_j, m_j = step_j(ts_j, batch)
        losses = [k for k in LOSSES if k in m_j]
        d_losses = [k[5:] for k in losses if k.startswith("loss/d_")]
        row = {"step": step, **{f"jax_{k[5:]}": float(m_j[k])
                                for k in losses}}
        for name, (step_t, ts) in ports.items():
            ports[name][1], m_t = step_t(ts, batch, draws=draws)
            gaps = []
            for k in losses:
                a, b = float(m_j[k]), float(m_t[k])
                row[f"{name}_{k[5:]}"] = b
                gaps.append(abs(a - b) / max(abs(a), abs(b), 1e-12))
                if summary[f"{name}_first_parting"] is None and parted(
                        a, b):
                    summary[f"{name}_first_parting"] = step
            row[f"{name}_max_rel_gap"] = max(gaps)
        rows.append(row)
        for name in ["jax"] + who:
            if summary[f"{name}_d_zero"] is None and all(
                    row[f"{name}_{k}"] == 0 for k in d_losses):
                summary[f"{name}_d_zero"] = step
        if step % args.log_every == 0 or step == args.steps:
            print(f"step {step} ({time.perf_counter() - t0:.0f} s): "
                  + " ".join(f"{k}={v:.5g}" for k, v in row.items()
                             if k != "step"), flush=True)
            _write_csv(os.path.join(args.out_dir, "lockstep.csv"), rows)
    summary["steps"] = len(rows)
    summary["seconds"] = time.perf_counter() - t0
    _write_csv(os.path.join(args.out_dir, "lockstep.csv"), rows)
    with open(os.path.join(args.out_dir, "lockstep.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print("lockstep " + json.dumps(summary))
    return summary


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mode", choices=("init", "lockstep"), required=True)
    p.add_argument("--gin_config", default=DEFAULT_CONFIG)
    p.add_argument("--gin_bindings", action="append", default=[])
    p.add_argument("--control_gin_bindings", action="append", default=[],
                   help="Lockstep: also run a control port with these "
                   "bindings on top (read when the GAN is built).")
    p.add_argument("--ch", type=int, default=96)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--workdir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--n_train", type=int, default=2000)
    p.add_argument("--polygon_workers", type=int, default=4)
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--log_every", type=int, default=10)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    sys.path.insert(0, ROOT)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    torch.set_num_threads(args.threads)
    return (run_init if args.mode == "init" else run_lockstep)(args)


if __name__ == "__main__":
    main()

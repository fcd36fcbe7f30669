"""The port's data-parallel train step, two gloo workers on the CPU, against
the JAX package's step on a 2-device mesh and against the port's own
one-process step, in the full TrainState.

The cases mirror tests/test_parallel.py:95,265,293,353,368: `dummy` with
disc_iters 2; ResNet-CIFAR with batch norm in G and spectral norm (moving
moments and SN `u` across workers); conditional BigGAN-32 with cBN, SN,
EMA and hinge (the attention takes its plain version on the CPU); SSGAN
and S3GAN on `dummy` (the rotated rows are the global batch's last and lie
on worker 1 only, so the workers' D batches differ in length; S3GAN's batch
holds unlabeled rows, so its class loss divides by the global count); and
DCGAN with batch norm in D and WGAN-GP (the penalty's double backward
through the cross-worker moments).

Both packages start from the port's init_state (carried by interop.py), take
the same global batch of 8 rows a sub-step (4 a worker) and the same draws
of z, sampled labels and alpha, drawn by the JAX package's own streams.
The workers run every case in one spawned pair (torch and the port only;
see `torch_helpers.run_dp_cases`) while this process runs the JAX side,
and hand their states back as checkpoints.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from tests import torch_helpers as th

from compare_gan_tpu import config as jgin
from compare_gan_tpu import datasets as jdatasets
from compare_gan_tpu.gans import modular_gan as jmodular
from compare_gan_tpu.gans import s3gan as js3gan
from compare_gan_tpu.gans import ssgan as jssgan
from compare_gan_tpu.ops import rng as jrng
from compare_gan_tpu.parallel import mesh_utils as jmesh
from compare_gan_torch import checkpoint, interop
from compare_gan_torch.parallel import mesh_utils

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 8
# Adam with a large epsilon is linear in small gradients, so a gradient
# that is rounding noise (a bias that feeds a batch norm) moves its
# parameter by noise, not by +-lr (tests/test_parallel.py:225-240).
LINEAR_ADAM = """
ModularGAN.g_optimizer_fn = @AdamOptimizer
ModularGAN.d_optimizer_fn = @AdamOptimizer
AdamOptimizer.epsilon = 1e-3
"""
DUMMY = {"architecture": "dummy_arch", "z_dim": 8, "lambda": 1,
         "disc_iters": 1}
CASES = {
    "dummy": dict(cls="ModularGAN", cfg="", dataset="cifar10",
                  parameters=dict(DUMMY, disc_iters=2)),
    "resnet_cifar": dict(
        cls="ModularGAN", dataset="cifar10",
        cfg=LINEAR_ADAM + """
G.batch_norm_fn = @batch_norm
G.spectral_norm = True
D.spectral_norm = True
standardize_batch.decay = 0.9
""", parameters={"architecture": "resnet_cifar_arch", "z_dim": 8,
                 "lambda": 1, "disc_iters": 1}),
    "biggan32": dict(
        cls="ModularGAN", dataset="cifar10",
        cfg=LINEAR_ADAM + """
weights.initializer = "orthogonal"
G.batch_norm_fn = @conditional_batch_norm
G.spectral_norm = True
D.spectral_norm = True
loss.fn = @hinge
standardize_batch.decay = 0.9
resnet_biggan.Generator.ch = 4
resnet_biggan.Generator.blocks_with_attention = "B2"
resnet_biggan.Discriminator.ch = 4
""", parameters={"architecture": "resnet_biggan_arch", "z_dim": 16,
                 "lambda": 1, "disc_iters": 1},
        kwargs={"conditional": True, "g_use_ema": True, "ema_start_step": 0}),
    "ssgan": dict(cls="SSGAN", cfg="", dataset="cifar10", parameters=DUMMY,
                  kwargs={"self_supervision": "rotation_gan",
                          "rotated_batch_size": 8}),
    "s3gan": dict(cls="S3GAN", cfg="", dataset="cifar10", parameters=DUMMY,
                  kwargs={"conditional": True, "self_supervision": "rotation",
                          "rotated_batch_fraction": 2, "project_y": True,
                          "use_predictor": True}),
    "dcgan_wgangp": dict(
        cls="ModularGAN", dataset="cifar10",
        cfg=LINEAR_ADAM + """
D.batch_norm_fn = @batch_norm
loss.fn = @wasserstein
penalty.fn = @wgangp_penalty
""", parameters={"architecture": "dcgan_arch", "z_dim": 16, "lambda": 10,
                 "disc_iters": 1}),
}
for _case in CASES.values():
    _case["batch"] = BATCH
JAX_CLASSES = {"ModularGAN": jmodular.ModularGAN, "SSGAN": jssgan.SSGAN,
               "S3GAN": js3gan.S3GAN}
# Biases whose exact gradient is zero: they feed a batch norm directly.
NOISE_GRAD = {
    "resnet_cifar": th.G_BN_FED_BIASES,
    "biggan32": th.G_BN_FED_BIASES,
    "dcgan_wgangp": frozenset(f"discriminator/d_conv{i}/bias"
                              for i in (2, 3, 4)),
}


# The Adam moments' tolerance (mu, nu), as a share of each optimizer's
# largest moment, where th.assert_train_states_close's (1e-4, 1e-8) is too
# tight for a gradient that f32 rounding moves further:
# * ResNet-CIFAR: G's first layer feeds a batch norm, whose backward
#   removes the batch mean: its gradient is a difference of terms of the
#   largest gradient's scale, so a small entry carries that scale's
#   rounding (measured: nu 1.2e-6 of the largest, workers against one
#   process).
# * DCGAN with WGAN-GP: after the penalty's D update, G's gradient through
#   D's batch norm is ill-conditioned in f32. At the same D weights f32
#   and f64 differ by 2.4e-3 of an entry of G's last bias gradient, while
#   the workers' step in f64 equals the one-process step in f64 to 3e-7
#   (the f32 storage of the weights); measured in f32: mu 9.2e-4, nu 7e-4
#   of the largest. (XLA's jitted f32 WGAN-GP penalty through this D is
#   1.152 against 2.7528; tests/test_torch_penalties.py.)
MOMENT_ATOL = {"resnet_cifar": (1e-4, 1e-5), "dcgan_wgangp": (5e-3, 5e-3)}


def _batch(case, seed):
    rng = np.random.RandomState(seed)
    total = BATCH * (case["parameters"]["disc_iters"] + 1)
    labels = rng.randint(0, 10, total).astype(np.int32)
    if case["cls"] == "S3GAN":
        labels[::3] = -1  # Unlabeled rows: the class loss skips them.
    return {"images": rng.rand(total, 32, 32, 3).astype(np.float32),
            "labels": labels}


def _jax_draws(jgan, ts, labels):
    """th.jax_draws plus each sub-step's penalty draws, all of the global
    batch, under the keys the JAX step draws them with."""
    draws = th.jax_draws(jgan, ts, labels, BATCH)
    for i, d in enumerate(draws):
        key = jrng.base_key_from_step(ts.rng, ts.step, sub_step=i)
        with jrng.rng_context(key):
            d["alpha"] = np.asarray(jrng.uniform((BATCH, 1, 1, 1),
                                                 name="alpha"))
    return draws


def _jax_gan(case):
    jgin.clear_config()
    jgin.parse_config(case["cfg"] + "attention.use_pallas = False\n")
    jdatasets.set_fake_dataset(True)
    return JAX_CLASSES[case["cls"]](
        dataset=jdatasets.get_dataset(case["dataset"]),
        parameters=case["parameters"], model_dir="unused",
        **case.get("kwargs", {}))


def _launch_workers(workdir):
    port = str(mesh_utils.free_port())
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    code = ("import sys; from tests import torch_helpers as th; "
            "th.run_dp_cases(int(sys.argv[1]), 2, int(sys.argv[2]), "
            "sys.argv[3])")
    logs = [open(os.path.join(workdir, f"worker{r}.log"), "w")
            for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), port,
                               workdir], cwd=REPO, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(2)]
    return procs, logs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (JAX new TrainState, JAX metrics)} after the workers have
    written their states into `workdir`."""
    workdir = str(tmp_path_factory.mktemp("dp_step"))
    started = {}
    for name, case in CASES.items():
        # The port's init, carried to a JAX TrainState (tracing the JAX
        # init of each case would cost as much as its step).
        ts_t = th.port_gan(case).init_state(seed=0)
        jgan = _jax_gan(case)
        ts = th.jax_train_state(jgan, ts_t)
        batch = _batch(case, seed=len(started))
        weights = {k: interop.to_jax(v)
                   for k, v in interop.state_dict(ts_t).items()}
        th.write_case_inputs(os.path.join(workdir, f"{name}.npz"), weights,
                             batch, _jax_draws(jgan, ts, batch["labels"]))
        started[name] = (ts, batch)
    with open(os.path.join(workdir, "cases.json"), "w") as f:
        json.dump(CASES, f)
    procs, logs = _launch_workers(workdir)
    try:
        results = {}
        for name, (ts, batch) in started.items():
            jgan = _jax_gan(CASES[name])
            mesh = jmesh.make_mesh(num_devices=2)
            step, shard_batch, ts = jmesh.compile_train_step(
                jgan, ts, mesh, BATCH)
            results[name] = step(ts, shard_batch(batch))
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
        jgin.clear_config()
        jdatasets.set_fake_dataset(False)
    for r, p in enumerate(procs):
        with open(os.path.join(workdir, f"worker{r}.log")) as f:
            assert p.returncode == 0, f"worker {r}:\n{f.read()[-4000:]}"
    return workdir, results


def _port_state(workdir, name, tag):
    """(TrainState, metrics) a worker wrote for a case."""
    gan = th.port_gan(CASES[name])
    ts = checkpoint.restore_checkpoint(
        os.path.join(workdir, name, tag, "model.ckpt-1.npz"),
        gan.init_state(seed=1))
    with np.load(os.path.join(workdir, name, tag, "metrics.npz")) as d:
        metrics = {k: d[k] for k in d.files}
    return ts, metrics


def _lr_steps(case):
    """Learning rate times the updates a parameter took in one step: one
    for G, disc_iters for D (both packages' default rate 2e-4)."""
    d_updates = case["parameters"]["disc_iters"]
    return lambda name: 2e-4 * (1 if name.startswith("generator/")
                                else d_updates)


@pytest.mark.parametrize("name", list(CASES))
def test_two_workers_match_the_jax_mesh_step(runs, name):
    workdir, results = runs
    ts_j, metrics_j = results[name]
    ts_t, metrics_t = _port_state(workdir, name, "rank0")
    assert ts_t.step == int(ts_j.step) == 1
    th.assert_train_states_close(ts_j, ts_t, metrics_j, metrics_t,
                                 _lr_steps(CASES[name]),
                                 NOISE_GRAD.get(name, ()),
                                 MOMENT_ATOL.get(name, (1e-4, 1e-8)))


def _tolerance(name, key, arrays):
    """(rtol, atol) of one checkpoint entry against the one-process step:
    those of the JAX comparison, for the same reason (f32 sums in another
    order: the workers sum half-batch moments and gradients where one
    process sums the whole batch)."""
    group = key.split("[")[0]
    if group in (".g_opt.mu", ".d_opt.mu", ".g_opt.nu", ".d_opt.nu"):
        largest = max(float(np.abs(v).max()) for k, v in arrays.items()
                      if k.startswith(group + "["))
        share = MOMENT_ATOL.get(name, (1e-4, 1e-8))[group.endswith("nu")]
        return 1e-3, share * largest
    if group == ".ema_params":
        return 1e-6, 1e-7
    return 1e-4, 1e-5  # Parameters, SN u, BN moments.


@pytest.mark.parametrize("name", list(CASES))
def test_two_workers_match_one_process(runs, name):
    """Rank 1 equals rank 0 bitwise (asserted in the workers too), and
    both equal the port's one-process step within `_tolerance`."""
    workdir = runs[0]
    arrays = {}
    for tag in ("rank0", "rank1", "single"):
        with np.load(os.path.join(workdir, name, tag,
                                  "model.ckpt-1.npz")) as d:
            arrays[tag] = {k: d[k] for k in d.files}
    single = arrays["single"]
    assert arrays["rank0"].keys() == arrays["rank1"].keys() == single.keys()
    for k, v in arrays["rank0"].items():
        np.testing.assert_array_equal(arrays["rank1"][k], v, err_msg=k)
        rtol, atol = _tolerance(name, k, single)
        np.testing.assert_allclose(v, single[k], rtol=rtol, atol=atol,
                                   err_msg=k)
    for tag in ("rank0", "rank1"):
        with np.load(os.path.join(workdir, name, tag, "metrics.npz")) as d:
            got = {k: d[k] for k in d.files}
        with np.load(os.path.join(workdir, name, "single",
                                  "metrics.npz")) as d:
            want = {k: d[k] for k in d.files}
        assert got.keys() == want.keys()
        for k in want:  # The losses as in th.assert_train_states_close.
            th.assert_close(got[k], want[k], rtol=1e-4, atol=1e-5, what=k)


def test_workers_load_no_jax(runs):
    workdir = runs[0]
    for r in range(2):
        with open(os.path.join(workdir, f"rank{r}.modules")) as f:
            loaded = set(f.read().split())
        assert "torch" in loaded
        assert not loaded & {"jax", "jaxlib", "optax", "compare_gan_tpu"}

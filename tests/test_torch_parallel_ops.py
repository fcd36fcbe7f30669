"""The port's collectives, grouped batch norm and weight-norm init over
four gloo workers on the CPU, against the JAX package's `tpu_ops` under
`shard_map` on a 4-device mesh (as tests/test_parallel.py:40-92 runs
them), its `standardize_batch` and the NumPy oracle of
tests/test_parallel.py:343-350; and the exchange of the hosts' input shares.

Grouped batch norm runs over all four workers (2 groups: each spans two
workers; 4: one a worker; 8: two inside each worker) and over the
sub-group of workers 0 and 1 (2 and 4 groups). The workers import torch
and the port only (`torch_helpers.run_dp_ops`) and hand their results back
as .npz files.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from tests import torch_helpers as th

from compare_gan_tpu import core as jcore
from compare_gan_tpu.ops import arch_ops as jops
from compare_gan_tpu.parallel import mesh_utils as jmesh
from compare_gan_tpu.parallel import tpu_ops as jtpu_ops
from compare_gan_torch.parallel import mesh_utils

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, [each worker's results])."""
    workdir = str(tmp_path_factory.mktemp("dp_ops"))
    rng = np.random.RandomState(0)
    inputs = {
        "v": rng.randn(WORLD, 3).astype(np.float32),
        "m": (rng.randn(4 * WORLD, 3) * 2 + 1).astype(np.float32),
        "w_concat": rng.randn(WORLD, 3).astype(np.float32),
        "a": rng.randn(3).astype(np.float32),
        "b": rng.randn(3).astype(np.float32),
        "x": (rng.randn(16, 4, 4, 3) + 0.5).astype(np.float32),
        "r": rng.randn(16, 4, 4, 3).astype(np.float32),
        "step_batch": rng.randn(24, 2, 3).astype(np.float32),
    }
    np.savez(os.path.join(workdir, "inputs.npz"), **inputs)
    port = str(mesh_utils.free_port())
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    code = ("import sys; from tests import torch_helpers as th; "
            f"th.run_dp_ops(int(sys.argv[1]), {WORLD}, int(sys.argv[2]), "
            "sys.argv[3])")
    logs = [open(os.path.join(workdir, f"worker{r}.log"), "w")
            for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), port,
                               workdir], cwd=REPO, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        for p in procs:
            p.wait(timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    results = []
    for r, p in enumerate(procs):
        with open(os.path.join(workdir, f"worker{r}.log")) as f:
            assert p.returncode == 0, f"worker {r}:\n{f.read()[-4000:]}"
        with np.load(os.path.join(workdir, f"rank{r}.npz")) as d:
            results.append({k: d[k] for k in d.files})
    return inputs, results


def _shard_map(fn, in_specs, out_specs):
    from jax.experimental.shard_map import shard_map
    mesh = jmesh.make_mesh(num_devices=WORLD)
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs))


def test_collectives_match_jax_under_shard_map(run):
    inputs, results = run
    v, m = inputs["v"], inputs["m"]
    concat = np.asarray(_shard_map(
        functools.partial(jtpu_ops.cross_replica_concat, axis_name="data"),
        P("data"), P("data"))(v))[:WORLD]
    mean = np.asarray(_shard_map(
        functools.partial(jtpu_ops.cross_replica_mean, axis_name="data"),
        P("data"), P("data"))(v))
    mean_g2 = np.asarray(_shard_map(
        functools.partial(jtpu_ops.cross_replica_mean, axis_name="data",
                          group_size=2), P("data"), P("data"))(v))
    moments = _shard_map(
        functools.partial(jtpu_ops.cross_replica_moments, axes=(0,),
                          axis_name="data"), P("data"), (P(), P()))(m)
    for r, got in enumerate(results):
        # Data movement and sums of 2-4 numbers: exact up to one rounding.
        np.testing.assert_array_equal(got["concat"], concat)
        np.testing.assert_allclose(got["mean"], mean[r:r + 1], rtol=1e-6)
        np.testing.assert_allclose(got["mean_g2"], mean_g2[r:r + 1],
                                   rtol=1e-6)
        # E[x^2] - E[x]^2 in f32 from sums over 16 rows (the port) or
        # means of 4 (JAX): a few roundings of E[x^2] ~ 5.
        np.testing.assert_allclose(got["moments_mean"],
                                   np.asarray(moments[0]), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got["moments_var"],
                                   np.asarray(moments[1]), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(results[0]["moments_var"], m.var(0),
                               rtol=1e-5)


def test_collective_gradients_cross_the_workers(run):
    """The gradient of one loss through the collectives reaches every
    worker's rows as the one-process gradient does."""
    inputs, results = run
    single = results[0]["single/moments_grad"]
    for r, got in enumerate(results):
        np.testing.assert_allclose(got["concat_grad"],
                                   inputs["w_concat"][r:r + 1], rtol=1e-6)
        # f32 sums of 16 rows in two orders, through E[x^2] - E[x]^2.
        np.testing.assert_allclose(got["moments_grad"],
                                   single[4 * r:4 * (r + 1)], rtol=1e-5,
                                   atol=1e-6)


def _jax_grouped_bn(x, r, groups):
    """(out, grad of sum(out * r) w.r.t. x, new state) of the JAX
    standardize_batch on the global batch."""
    def f(x_):
        return jops.standardize_batch(x_, is_training=True,
                                      num_batch_groups=groups, decay=0.9)

    _, params, state = jcore.init(f, jax.random.PRNGKey(0), x)

    def loss(x_):
        out, new_state = jcore.apply(f, params, state, x_)
        return jnp.sum(out * r), (out, new_state)

    (_, (out, new_state)), grad = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(x))
    return np.asarray(out), np.asarray(grad), new_state


def _oracle(x, groups):
    """tests/test_parallel.py:343-350: moments per contiguous group."""
    xg = x.reshape(groups, -1, *x.shape[1:])
    mean_g = xg.mean(axis=(1, 2, 3), keepdims=True)
    var_g = (xg ** 2).mean(axis=(1, 2, 3), keepdims=True) - mean_g ** 2
    return ((xg - mean_g) / np.sqrt(var_g + 1e-3)).reshape(x.shape)


@pytest.mark.parametrize("layout,groups", [
    ("all", 2), ("all", 4), ("all", 8), ("pair", 2), ("pair", 4)])
def test_grouped_batch_norm_over_workers(run, layout, groups):
    """Each group's rows normalized by the group's moments, whether a group
    spans workers or sits inside one; the moving moments (the mean of the
    groups') equal on every worker. f32 moments of 8-32 values of ~1:
    1e-5 relative, 1e-5 absolute."""
    inputs, results = run
    x, r = inputs["x"], inputs["r"]
    workers = results if layout == "all" else results[:2]
    key = f"{layout}/g{groups}"
    out = np.concatenate([w[f"{key}/out"] for w in workers])
    grad = np.concatenate([w[f"{key}/grad"] for w in workers])
    want_out, want_grad, state = _jax_grouped_bn(x, r, groups)
    np.testing.assert_allclose(out, want_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, _oracle(x, groups), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(grad, want_grad, rtol=1e-4, atol=1e-5)
    for name in ("moving_mean", "moving_variance"):
        for w in workers:
            np.testing.assert_array_equal(w[f"{key}/{name}"],
                                          workers[0][f"{key}/{name}"])
        np.testing.assert_allclose(workers[0][f"{key}/{name}"],
                                   np.asarray(state[name]), rtol=1e-5,
                                   atol=1e-6)


def test_weight_norm_init_takes_the_global_batch_moments(run):
    """In a data-parallel step the init sets g and b from the moments of
    the global batch, the same on every worker: the one-process init on
    the whole batch, up to E[x^2] - E[x]^2 in place of the two-pass
    variance (f32, 1e-5)."""
    _, results = run
    for name in ("g", "b"):
        want = results[0][f"single/wn/{name}"]
        for got in results:
            np.testing.assert_array_equal(got[f"wn/{name}"],
                                          results[0][f"wn/{name}"])
            np.testing.assert_allclose(got[f"wn/{name}"], want, rtol=1e-5,
                                       atol=1e-6)


def test_each_worker_receives_its_blocks_from_the_hosts_shares(run):
    """Four workers as two hosts, each holding half of a global step batch
    of 3 sub-steps of 8 rows (sub-step 1 straddles the hosts): one
    all-to-all brings each worker its 2 rows of every sub-step, the rows
    the JAX mesh puts on its device; the labels' gather gives every worker
    the whole batch. Data movement only: exact."""
    inputs, results = run
    batch = inputs["step_batch"]
    for r, got in enumerate(results):
        want = np.concatenate([batch[i + 2 * r:i + 2 * r + 2]
                               for i in range(0, 24, 8)])
        np.testing.assert_array_equal(got["hosts/blocks"], want)
        np.testing.assert_array_equal(got["hosts/gathered"], batch)

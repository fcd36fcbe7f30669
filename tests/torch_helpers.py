"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Importing this module pins torch to one thread: the tests run in several
xdist workers on one host, and torch's default thread count per worker
would oversubscribe it.
"""

import numpy as np
import torch

torch.set_num_threads(1)


def one_blas_thread():
    """A context of one BLAS thread (threadpoolctl), for tests that take
    FID's 2048x2048 matrix square roots: OpenBLAS's own threads spin while
    the other xdist workers hold the cores, which made one such test 4x
    slower on an 8-core host."""
    from threadpoolctl import threadpool_limits
    return threadpool_limits(limits=1, user_api="blas")


def randn(shape, seed, scale=1.0):
    """float32 normal draws from numpy, for feeding both packages."""
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def np32(x):
    """A jax array, torch tensor or numpy array as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np32(got), np32(want), rtol=rtol, atol=atol,
                               err_msg=what)


def load_jax(module, prefix, params, state=None):
    """Copy JAX variables (keyed by JAX name) into a port module whose
    variables are named under `prefix`; the two name sets must be equal."""
    from compare_gan_torch import core, interop
    p, b = core.named_variables(module, prefix)
    want = {**p, **b}
    have = {**params, **(state or {})}
    assert set(want) == set(have), sorted(set(want) ^ set(have))
    with torch.no_grad():
        for k, t in want.items():
            t.copy_(interop.to_port(have[k]))


def filled_accumulators(state, seed):
    """A JAX state tree with its BN accumulators as a fill leaves them
    (sums over 2 batches, switch off), so that eval-mode BN normalizes by
    statistics of the scale of the activations, not by the init's zeros."""
    import jax.numpy as jnp
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in state.items():
        if k.endswith("accu_counter"):
            v = jnp.float32(2.0)
        elif k.endswith("accu_mean"):
            v = jnp.asarray(0.2 * rng.randn(*v.shape), jnp.float32)
        elif k.endswith("accu_variance"):
            v = jnp.asarray(2.0 + rng.rand(*v.shape), jnp.float32)
        out[k] = v
    return out


# Biases followed directly by a batch norm in a 3-block G (BigGAN-32 and
# ResNet-CIFAR name them alike: bn2 of each block reads up_conv1; the last
# block's output goes to final_norm): their exact gradient is zero.
G_BN_FED_BIASES = frozenset({
    "generator/B1/up_conv1/bias", "generator/B2/up_conv1/bias",
    "generator/B3/up_conv1/bias", "generator/B3/same_conv2/bias",
    "generator/B3/up_conv_shortcut/bias"})


def jax_draws(jgan, ts, labels, batch_size):
    """Each sub-step's z and sampled labels from the JAX package's own
    streams (`labels`: the step's labels, split per sub-step), as numpy
    arrays to hand to the port's train step."""
    import jax.numpy as jnp
    from compare_gan_tpu.ops import rng as jrng

    n = jgan.num_sub_steps
    draws = []
    for i, sub_labels in enumerate(np.split(labels, n)):
        key = jrng.base_key_from_step(ts.rng, ts.step, sub_step=i)
        with jrng.rng_context(key):
            d = jgan._draw_sub_step_inputs(batch_size,
                                           jnp.asarray(sub_labels))
        draws.append({k: np.asarray(v) for k, v in d.items()})
    return draws


def jax_train_state(jgan, ts_t):
    """The JAX TrainState holding the port TrainState's values, with fresh
    optimizer states and step counters at 0. Copies: a JAX array may alias
    the numpy memory it was made from, which the port updates in place."""
    import jax
    import jax.numpy as jnp
    from compare_gan_tpu.gans import modular_gan as jmodular
    from compare_gan_torch import interop

    params, state, ema = (
        {k: jnp.array(v, copy=True) for k, v in tree.items()}
        for tree in interop.params_to_jax(interop.state_dict(ts_t)))
    g_tx, d_tx = jgan._make_optimizers()
    return jmodular.TrainState(
        params=params, state=state, ema_params=ema,
        g_opt=g_tx.init(jgan.generator.trainable_variables(params)),
        d_opt=d_tx.init(jgan.discriminator.trainable_variables(params)),
        step=jnp.zeros((), jnp.int32), disc_step=jnp.zeros((), jnp.int32),
        rng=jax.random.PRNGKey(3))


def _max_abs(tree):
    return max(float(np.abs(np.asarray(v)).max()) for v in tree.values())


def assert_train_states_close(ts_j, ts_t, metrics_j, metrics_t, lr_steps,
                              noise_grad=(), moment_atol=(1e-4, 1e-8)):
    """The port's TrainState and step metrics against the JAX package's
    after the same steps. `lr_steps(name)` is the learning rate times the
    updates a parameter has taken; `noise_grad` names the parameters whose
    exact gradient is zero (a bias that feeds a batch norm directly);
    `moment_atol` scales the Adam moments' tolerance (mu, nu) below."""
    from compare_gan_torch import interop

    # Losses: f32 forwards of ~40 layers on two CPU backends, 1e-4.
    assert set(metrics_j) == set(metrics_t)
    for k in metrics_j:
        assert_close(metrics_t[k], metrics_j[k], rtol=1e-4, atol=1e-5,
                     what=k)
    params_j, state_j, ema_j = (ts_j.params, ts_j.state, ts_j.ema_params)
    params_t, state_t, ema_t = interop.params_to_jax(interop.state_dict(ts_t))
    assert set(params_t) == set(params_j) and set(state_t) == set(state_j)
    # Adam's update is ~lr*g/|g|, so a parameter whose gradient is
    # mathematically zero moves by +-lr on the sign of rounding noise: they
    # get 2*lr per update taken; every other parameter 1e-5 (f32 gradients
    # agree to ~1e-6 of their scale, so the sign of each update agrees).
    for name in params_j:
        atol = 2 * lr_steps(name) if name in noise_grad else 1e-5
        assert_close(params_t[name], params_j[name], rtol=1e-4, atol=atol,
                     what=name)
    # Moments: f32 gradient sums whose rounding scales with the network's
    # largest gradients, not with each entry (a conv bias followed by a
    # batch norm has a gradient that is rounding noise, ~1e-9, on both
    # sides): 1e-3 relative plus 1e-4 of the largest moment of the
    # network (1e-4 squared for nu).
    for opt_t, opt_j in ((ts_t.g_opt, ts_j.g_opt[0]),
                         (ts_t.d_opt, ts_j.d_opt[0])):
        assert opt_t.count == int(opt_j.count)
        for moment in ("mu", "nu"):
            want_all = getattr(opt_j, moment)
            assert set(getattr(opt_t, moment)) == set(want_all)
            atol = moment_atol[moment == "nu"] * _max_abs(want_all)
            for name, got in getattr(opt_t, moment).items():
                assert_close(interop.to_jax(got), want_all[name], rtol=1e-3,
                             atol=atol, what=f"{moment} {name}")
    # SN u vectors: unit vectors from a power iteration, 1e-4.
    for name in state_j:
        assert_close(state_t[name], state_j[name], rtol=1e-4, atol=1e-5,
                     what=name)
    # EMA = 0.9999 e + 1e-4 p: the parameters' tolerance, scaled by 1e-4.
    assert set(ema_t) == set(ema_j)
    for name in ema_j:
        atol = 2e-4 * lr_steps(name) if name in noise_grad else 1e-7
        assert_close(ema_t[name], ema_j[name], rtol=1e-6, atol=atol,
                     what=name)


# ---------------------------------------------------------------------------
# Data-parallel workers (tests/test_torch_dp_*.py)
# ---------------------------------------------------------------------------

GAN_CLASSES = ("ModularGAN", "SSGAN", "S3GAN")


def port_gan(case, device="cpu"):
    """The port's GAN of a case dict (cls, dataset, parameters, kwargs),
    with the case's gin config parsed."""
    from compare_gan_torch import config as tgin
    from compare_gan_torch import datasets
    from compare_gan_torch.gans import modular_gan, s3gan, ssgan

    classes = dict(zip(GAN_CLASSES, (modular_gan.ModularGAN, ssgan.SSGAN,
                                     s3gan.S3GAN)))
    tgin.clear_config()
    tgin.parse_config(case["cfg"])
    datasets.set_fake_dataset(True)
    return classes[case["cls"]](
        dataset=datasets.get_dataset(case["dataset"]),
        parameters=case["parameters"], model_dir="unused", device=device,
        **case.get("kwargs", {}))


def case_inputs(path):
    """(weights, batch, draws) written by `write_case_inputs`."""
    with np.load(path) as d:
        weights = {k[len("w"):]: d[k] for k in d.files if k.startswith("w.")}
        batch = {k: d[f"batch/{k}"] for k in ("images", "labels")}
        draws = []
        while f"draw{len(draws)}/z" in d.files:
            prefix = f"draw{len(draws)}/"
            draws.append({k[len(prefix):]: d[k] for k in d.files
                          if k.startswith(prefix)})
    return weights, batch, draws


def write_case_inputs(path, weights, batch, draws):
    """An .npz of checkpoint-keyed JAX-layout weights, the step's global
    batch and each sub-step's global draws."""
    arrays = {f"w{k}": np.asarray(v) for k, v in weights.items()}
    arrays.update({f"batch/{k}": np.asarray(v) for k, v in batch.items()})
    for i, d in enumerate(draws):
        arrays.update({f"draw{i}/{k}": np.asarray(v) for k, v in d.items()})
    np.savez(path, **arrays)


def run_dp_cases(rank, world, port, workdir):
    """One gloo worker of a data-parallel test on the CPU: joins the group
    of `world` workers at 127.0.0.1:port and, for each case of
    `workdir/cases.json`, takes one train step of the global batch and
    draws in `workdir/<case>.npz` from the weights there. Writes its
    TrainState as `workdir/<case>/rank<r>/model.ckpt-1.npz` and its
    metrics beside it, checks that its state equals rank 0's bitwise, and
    on rank 0 also writes the one-process step (`.../single/`). Imports
    torch and the port only; the last file it writes, `rank<r>.modules`,
    lists the top-level modules it loaded."""
    import json
    import os
    import sys

    from compare_gan_torch import checkpoint, interop
    from compare_gan_torch.parallel import mesh_utils

    replicas = mesh_utils.init_process_group(rank, world, "127.0.0.1", port,
                                             torch.device("cpu"))
    with open(os.path.join(workdir, "cases.json")) as f:
        cases = json.load(f)
    try:
        for name, case in cases.items():
            weights, batch, draws = case_inputs(
                os.path.join(workdir, f"{name}.npz"))
            runs = [(f"rank{rank}", replicas)]
            if rank == 0:
                runs.append(("single", None))
            for tag, reps in runs:
                gan = port_gan(case)
                ts = gan.init_state(seed=1)
                interop.load_state_dict(ts, {k: interop.to_port(v)
                                             for k, v in weights.items()})
                step = gan.make_train_step(case["batch"], reps)
                ts, metrics = step(ts, batch, draws=draws)
                mesh_utils.assert_replicated(checkpoint.live_tensors(ts),
                                             reps)
                out = os.path.join(workdir, name, tag)
                checkpoint.write_arrays(out, checkpoint.to_arrays(ts), 1)
                np.savez(os.path.join(out, "metrics.npz"),
                         **{k: np32(v) for k, v in metrics.items()})
    finally:
        mesh_utils.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.modules"), "w") as f:
        f.write("\n".join(sorted({m.split(".")[0] for m in sys.modules})))


def run_dp_ops(rank, world, port, workdir):
    """One gloo worker of tests/test_torch_parallel_ops.py: joins the group
    of `world` workers at 127.0.0.1:port, runs the collectives, grouped
    batch norm and the weight-norm init on its rows of the arrays in
    `workdir/inputs.npz`, and writes what it got to
    `workdir/rank<r>.npz`; rank 0 also writes the one-process results
    (keys `single/...`). Over every worker, and over the sub-group of
    workers 0 and 1; the host exchange with the workers as two hosts."""
    import os

    import torch.distributed as dist

    from compare_gan_torch import core
    from compare_gan_torch.ops import arch_ops
    from compare_gan_torch.parallel import mesh_utils, tpu_ops

    replicas = mesh_utils.init_process_group(rank, world, "127.0.0.1", port,
                                             torch.device("cpu"))
    pair = dist.new_group([0, 1])
    with np.load(os.path.join(workdir, "inputs.npz")) as d:
        inputs = {k: torch.from_numpy(d[k]) for k in d.files}
    out = {}

    def record(key, value):
        out[key] = np32(value)

    def grad_of(fn, x, weight):
        x = x.clone().requires_grad_()
        y = fn(x)
        g, = torch.autograd.grad((y * weight).sum(), x)
        return y, g

    try:
        v = inputs["v"]  # [world, 3]: one row a worker.
        mine = replicas.rows(v, world)
        record("concat", tpu_ops.cross_replica_concat(mine, replicas))
        record("mean", tpu_ops.cross_replica_mean(mine, replicas))
        record("mean_g2", tpu_ops.cross_replica_mean(mine, replicas, 2))
        m = inputs["m"]  # [4 * world, 3]
        mean, var = tpu_ops.cross_replica_moments(replicas.rows(m, len(m)),
                                                  replicas)
        record("moments_mean", mean)
        record("moments_var", var)
        # Gradients through the collectives: of sum(w * concat) and of
        # sum(a * mean + b * var), w.r.t. this worker's rows.
        # Each worker's loss is its share, 1 / world, of one replicated
        # loss: the gradients are those of the one loss.
        w = inputs["w_concat"]
        _, g = grad_of(lambda t: tpu_ops.cross_replica_concat(t, replicas),
                       mine, w / world)
        record("concat_grad", g)
        a, b = inputs["a"], inputs["b"]

        def moments_loss(t, reps):
            mu, s2 = (tpu_ops.cross_replica_moments(t, reps) if reps
                      else (t.mean(0), t.var(0, unbiased=False)))
            return a * mu + b * s2

        _, g = grad_of(lambda t: moments_loss(t, replicas),
                       replicas.rows(m, len(m)), 1.0 / world)
        record("moments_grad", g)
        if rank == 0:
            _, g = grad_of(lambda t: moments_loss(t, None), m, 1.0)
            record("single/moments_grad", g)

        # Grouped batch norm: over every worker, and over workers 0 and 1.
        x, r = inputs["x"], inputs["r"]
        layouts = [("all", replicas, (2, 4, 8))]
        if rank < 2:
            layouts.append(("pair", mesh_utils.Replicas(
                rank=rank, world=2, group=pair), (2, 4)))
        for tag, reps, group_counts in layouts:
            for groups in group_counts:
                bn = arch_ops.StandardizeBatch(x.shape[-1], decay=0.9,
                                               num_batch_groups=groups)
                core.initialize(bn, "bn", 0)
                with mesh_utils.replica_context(reps):
                    y, g = grad_of(lambda t: bn(t, is_training=True),
                                   reps.rows(x, len(x)),
                                   reps.rows(r, len(r)))
                key = f"{tag}/g{groups}"
                record(f"{key}/out", y)
                record(f"{key}/grad", g)
                record(f"{key}/moving_mean", bn.moving_mean)
                record(f"{key}/moving_variance", bn.moving_variance)
        # The weight-norm init from the global batch's moments.
        conv = arch_ops.WeightNormConv2d(x.shape[-1], 5, 3, 3, 1, 1)
        core.initialize(conv, "wn", 0)
        with mesh_utils.replica_context(replicas):
            conv(replicas.rows(x, len(x)), init=True)
        record("wn/g", conv.g)
        record("wn/b", conv.b)
        if rank == 0:
            conv = arch_ops.WeightNormConv2d(x.shape[-1], 5, 3, 3, 1, 1)
            core.initialize(conv, "wn", 0)
            conv(x, init=True)
            record("single/wn/g", conv.g)
            record("single/wn/b", conv.b)
        # The workers as two hosts of two: each host holds its half of a
        # global step batch of 3 sub-steps of 8 rows.
        hosts = mesh_utils.Replicas(rank=rank, world=world, num_hosts=2)
        step_batch = inputs["step_batch"]
        share = len(step_batch) // 2
        host_rows = step_batch[hosts.host_id * share:
                               (hosts.host_id + 1) * share]
        record("hosts/blocks", hosts.exchange_blocks(host_rows, 8))
        record("hosts/gathered", hosts.gather_hosts(host_rows))
    finally:
        mesh_utils.destroy_process_group()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)


# ---------------------------------------------------------------------------
# The spatial layout's workers (tests/test_torch_spatial_*.py)
# ---------------------------------------------------------------------------


def _spatial_op_cases():
    """{name: (build() -> module, input shape [B, H, W, C] of the whole
    image, forward(module, x, y) -> (output, whether it is a band))}."""
    from compare_gan_torch.architectures import resnet_ops
    from compare_gan_torch.ops import arch_ops as ops
    from compare_gan_torch.parallel import tpu_ops

    def band(m, x, y):
        return m(x), True

    def bn(m, x, y):
        return m(x, is_training=True), True

    def cbn(m, x, y):
        return m(x, is_training=True, y=y), True

    def deconv(m, x, y):  # To twice the whole image's size.
        return m(x, (2 * tpu_ops.image_rows(x), 2 * x.shape[2])), True

    def whole(fn):
        return lambda m, x, y: (fn(m, x), False)

    return {
        "conv3x3_sn": (lambda: ops.Conv2d(4, 5, 3, 3, use_sn=True),
                       (2, 8, 6, 4), band),
        "conv5x5_stride2": (lambda: ops.Conv2d(4, 5, 5, 5, 2, 2),
                            (2, 16, 8, 4), band),
        "conv1x1": (lambda: ops.conv1x1(4, 5), (2, 8, 6, 4), band),
        "deconv5x5_stride2": (lambda: ops.Deconv2d(4, 5, 5, 5, 2, 2,
                                                   use_sn=True),
                              (2, 4, 4, 4), deconv),
        "deconv5x5_stride2_one_row": (
            lambda: ops.Deconv2d(4, 5, 5, 5, 2, 2), (2, 2, 2, 4), deconv),
        "up_conv3x3": (lambda: ops.UpConv2d(4, 5, 3, 3, use_sn=True),
                       (2, 4, 4, 4), band),
        "up_conv1x1": (lambda: ops.UpConv2d(4, 5, 1, 1), (2, 4, 4, 4), band),
        "down_conv3x3": (lambda: ops.DownConv2d(4, 5, 3, 3, use_sn=True),
                         (2, 8, 8, 4), band),
        "down_conv1x1": (lambda: ops.DownConv2d(4, 5, 1, 1), (2, 8, 8, 4),
                         band),
        "unpool_conv3x3": (lambda: resnet_ops.UnpoolConv2d(4, 5, 3, 3),
                           (2, 4, 4, 4), band),
        "conv3x3_avg_pool": (lambda: resnet_ops.ConvAvgPool2d(4, 5, 3, 3),
                             (2, 8, 8, 4), band),
        "batch_norm": (lambda: ops.BatchNorm(4), (3, 8, 6, 4), bn),
        "conditional_batch_norm": (
            lambda: ops.ConditionalBatchNorm(4, 3, use_sn=True),
            (3, 8, 6, 4), cbn),
        "non_local_block": (lambda: ops.NonLocalBlock(16, use_sn=True),
                            (2, 8, 8, 16), band),
        "linear_of_bands": (lambda: ops.Linear(8 * 6 * 4, 3, use_sn=True),
                            (2, 8, 6, 4), whole(lambda m, x: m.of_bands(x))),
        "spatial_sum": (lambda: ops.conv1x1(4, 5), (2, 8, 6, 4),
                        whole(lambda m, x: tpu_ops.spatial_sum(m(x)))),
    }


def run_spatial_ops(rank, world, port, workdir):
    """One gloo worker of tests/test_torch_spatial_ops.py: a `1 x world`
    grid (every worker one band of image height). For each op of
    `_spatial_op_cases`, from weights of one seed: its output on this
    worker's band of `workdir/inputs.npz`'s whole input (`<op>/x`, and
    `<op>/y` for the conditional one), and the gradients of sum(output *
    r) (r: normal draws of seed 1 in the whole output's shape; this
    worker's band of it, or all of it over `world` for an output every
    worker holds whole) with respect to the band and to each parameter;
    also each state buffer after the forward. Writes
    `workdir/rank<r>.npz`; rank 0 also writes the one-process results
    under `single/`."""
    import os

    from compare_gan_torch import core
    from compare_gan_torch.parallel import mesh_utils

    replicas = mesh_utils.init_process_group(
        rank, world, "127.0.0.1", port, torch.device("cpu"),
        model_size=world)
    with np.load(os.path.join(workdir, "inputs.npz")) as d:
        inputs = {k: torch.from_numpy(d[k]) for k in d.files}
    out = {}
    try:
        runs = [("", replicas)] + ([("single/", None)] if rank == 0 else [])
        for name, (build, _, forward) in _spatial_op_cases().items():
            for prefix, reps in runs:
                module = build()
                core.assign_scopes(module, name)
                core.initialize(module, name, 0)
                if isinstance(getattr(module, "sigma", None), torch.Tensor):
                    with torch.no_grad():
                        module.sigma.fill_(0.5)  # Open the attention gate.
                x = inputs[f"{name}/x"]
                y = inputs.get(f"{name}/y")
                if reps is not None:
                    x = reps.band(x)
                x = x.clone().requires_grad_()
                params = [p for _, p in sorted(module.named_parameters())]
                with mesh_utils.replica_context(reps):
                    got, banded = forward(module, x, y)
                shape = list(got.shape)
                if reps is not None and banded:
                    shape[1] *= world
                r = torch.from_numpy(randn(shape, seed=1))
                if reps is not None:
                    r = reps.band(r) if banded else r / world
                grads = torch.autograd.grad((got * r).sum(), [x] + params)
                key = f"{prefix}{name}"
                out[f"{key}/out"] = np32(got)
                out[f"{key}/dx"] = np32(grads[0])
                for (pname, _), g in zip(sorted(module.named_parameters()),
                                         grads[1:]):
                    out[f"{key}/d:{pname}"] = np32(g)
                for bname, b in module.named_buffers():
                    out[f"{key}/state:{bname}"] = np32(b)
    finally:
        mesh_utils.destroy_process_group()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)


def run_spatial_cases(rank, world, port, workdir, model_size=2):
    """One gloo worker of tests/test_torch_spatial_step.py: joins a `world
    / model_size x model_size` grid at 127.0.0.1:port and, for each case
    of `workdir/cases.json`, takes one train step of the global batch and
    draws in `workdir/<case>.npz` from the weights there, in the spatial
    layout; then, on rank 0's behalf, with each of the case's faulty
    `controls` (chip_smoke.spatial_control). Writes as `run_dp_cases`
    does (`<case>/rank<r>`, on rank 0 also `<case>/single` and
    `<case>/<control>`), and `hosts<r>.npz`: the step batch exchanged
    between the grid's workers as two hosts."""
    import json
    import os
    import sys

    import chip_smoke
    from compare_gan_torch import checkpoint, interop
    from compare_gan_torch.parallel import mesh_utils

    replicas = mesh_utils.init_process_group(
        rank, world, "127.0.0.1", port, torch.device("cpu"),
        model_size=model_size)
    with open(os.path.join(workdir, "cases.json")) as f:
        cases = json.load(f)
    try:
        for name, case in cases.items():
            weights, batch, draws = case_inputs(
                os.path.join(workdir, f"{name}.npz"))
            runs = [(f"rank{rank}", replicas, None)] + [
                (control, replicas, control)
                for control in case.get("controls", ())]
            if rank == 0:
                runs.append(("single", None, None))
            for tag, reps, control in runs:
                gan = port_gan(case)
                ts = gan.init_state(seed=1)
                interop.load_state_dict(ts, {k: interop.to_port(v)
                                             for k, v in weights.items()})
                step = gan.make_train_step(case["batch"], reps)
                with chip_smoke.spatial_control(control):
                    ts, metrics = step(ts, batch, draws=draws)
                mesh_utils.assert_replicated(checkpoint.live_tensors(ts),
                                             reps)
                if rank and not tag.startswith("rank"):
                    continue
                out = os.path.join(workdir, name, tag)
                checkpoint.write_arrays(out, checkpoint.to_arrays(ts), 1)
                np.savez(os.path.join(out, "metrics.npz"),
                         **{k: np32(v) for k, v in metrics.items()})
        # Two hosts of two workers: each host holds its half of a step
        # batch of 3 sub-steps of 8 rows.
        hosts = mesh_utils.Replicas(
            rank=rank, world=world, num_hosts=2, model_size=model_size,
            model_group=replicas.model_group)
        step_batch = torch.arange(24 * 2, dtype=torch.float32).reshape(24, 2)
        share = len(step_batch) // 2
        np.savez(os.path.join(workdir, f"hosts{rank}.npz"),
                 blocks=np32(hosts.exchange_blocks(
                     step_batch[hosts.host_id * share:
                                (hosts.host_id + 1) * share], 8)))
    finally:
        mesh_utils.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.modules"), "w") as f:
        f.write("\n".join(sorted({m.split(".")[0] for m in sys.modules})))

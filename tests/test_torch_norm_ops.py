"""The port's last arch ops against the JAX package's, f32 on the CPU:
EvoNorm-S0 (forward, gradients, batch independence, and as
`G.batch_norm_fn` through one ModularGAN step), the three weight-norm
layers with their data-dependent init (tests/test_arch_ops.py:122-130),
and `standardize_batch.num_batch_groups` in one process, against JAX and
the NumPy oracle of tests/test_parallel.py:343-350."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers as th

from compare_gan_tpu import config as jgin
from compare_gan_tpu import core as jcore
from compare_gan_tpu import datasets as jdatasets
from compare_gan_tpu.gans import modular_gan as jmodular
from compare_gan_tpu.ops import arch_ops as jops
from compare_gan_torch import config as tgin
from compare_gan_torch import core, datasets, interop
from compare_gan_torch.ops import arch_ops as ops

# f32 convolutions, matmuls and reductions on two CPU backends: the same
# sums in another order, ~1e-6 relative (as tests/test_torch_arch_ops.py).
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    yield
    tgin.clear_config()
    datasets.set_fake_dataset(False)
    jdatasets.set_fake_dataset(False)


def _port(module, prefix, params):
    core.assign_scopes(module, prefix)
    th.load_jax(module, prefix, params)
    return module


# C = 48 and 20 are not powers of two: their groups are 24 and 20.
@pytest.mark.parametrize("c", [48, 20, 64])
def test_evonorm_s0_forward_and_gradients(c):
    x = th.randn((2, 4, 4, c), 1, scale=2.0)
    r = th.randn((2, 4, 4, c), 2)
    params = {"ev/gamma": th.randn((c,), 3) + 1, "ev/beta": th.randn((c,), 4),
              "ev/v": th.randn((c,), 5)}

    def loss(p, x_):
        out, _ = jcore.apply(lambda v: jops.evonorm_s0(v, name="ev"), p, {},
                             x_)
        return jnp.sum(out * r), out

    (_, want), (want_dp, want_dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    ev = _port(ops.EvoNormS0(c), "ev", params)
    assert ev.groups == max(g for g in range(1, 33) if c % g == 0)
    xt = torch.from_numpy(x).requires_grad_()
    got = ev(xt, is_training=True)
    (got * torch.from_numpy(r)).sum().backward()
    th.assert_close(got, want, RTOL, ATOL)
    th.assert_close(xt.grad, want_dx, RTOL, ATOL)
    for name in ("gamma", "beta", "v"):
        th.assert_close(getattr(ev, name).grad, want_dp[f"ev/{name}"],
                        RTOL, ATOL, what=name)


def test_evonorm_s0_is_batch_independent():
    """Example 0's output does not depend on example 1: no moments of the
    batch, so nothing to reduce across workers."""
    x = torch.from_numpy(th.randn((2, 4, 4, 8), 1))
    ev = ops.EvoNormS0(8)
    core.initialize(ev, "ev", 0)
    torch.testing.assert_close(ev(x)[:1], ev(x[:1]), rtol=0, atol=0)


@pytest.mark.parametrize("shape,groups", [((8, 4, 4, 3), 2),
                                          ((6, 5), 3)])
@pytest.mark.parametrize("moving", [True, False])
def test_grouped_standardize_batch_in_one_process(shape, groups, moving):
    """num_batch_groups in one process is a reshape, as in JAX: training
    output and gradients per group; the moving moments (moving-average
    mode) or the accumulators' inference output (accumulator mode) from
    the mean of the groups' moments."""
    x = th.randn(shape, 1, scale=1.5) + 0.5
    r = th.randn(shape, 2)

    def f(x_, is_training):
        return jops.standardize_batch(
            x_, is_training=is_training, num_batch_groups=groups, decay=0.9,
            use_moving_averages=moving)

    _, params, state = jcore.init(lambda v: f(v, True),
                                  jax.random.PRNGKey(0), x)
    if not moving:
        state = dict(state, **{"accu/update_accus": jnp.ones((), jnp.int32)})

    def loss(x_):
        out, new_state = jcore.apply(lambda v: f(v, True), params, state, x_)
        return jnp.sum(out * r), (out, new_state)

    (_, (want, want_state)), want_dx = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(jnp.asarray(x))

    bn = ops.StandardizeBatch(shape[-1], decay=0.9, num_batch_groups=groups,
                              use_moving_averages=moving)
    core.initialize(bn, "bn", 0)
    if not moving:
        bn._buffers["accu/update_accus"].fill_(1)
    xt = torch.from_numpy(x).requires_grad_()
    got = bn(xt, is_training=True)
    (got * torch.from_numpy(r)).sum().backward()
    th.assert_close(got, want, RTOL, ATOL)
    th.assert_close(xt.grad, want_dx, RTOL, ATOL)
    if len(shape) == 4:
        xg = x.reshape(groups, -1, *shape[1:])
        mean_g = xg.mean(axis=(1, 2, 3), keepdims=True)
        var_g = (xg ** 2).mean(axis=(1, 2, 3), keepdims=True) - mean_g ** 2
        oracle = ((xg - mean_g) / np.sqrt(var_g + 1e-3)).reshape(shape)
        th.assert_close(got, oracle, RTOL, ATOL)
    if moving:
        for name in ("moving_mean", "moving_variance"):
            th.assert_close(bn._buffers[name], want_state[name], 1e-5, 1e-6,
                            what=name)
    else:
        # Inference mode adds the mean of the groups' moments to the
        # accumulators and normalizes by them.
        want_eval, want_accu = jcore.apply(lambda v: f(v, False), params,
                                           state, jnp.asarray(x))
        got_eval = bn(torch.from_numpy(x), is_training=False)
        th.assert_close(got_eval, want_eval, RTOL, ATOL)
        th.assert_close(bn._buffers["accu/accu_mean"],
                        want_accu["accu/accu_mean"], 1e-5, 1e-6)


def test_grouped_standardize_batch_refuses_a_batch_it_cannot_split():
    bn = ops.StandardizeBatch(3, num_batch_groups=4)
    core.initialize(bn, "bn", 0)
    with pytest.raises(ValueError):
        bn(torch.zeros(6, 2, 2, 3), is_training=True)


def _jax_weight_norm(fn, x):
    """(out, params) of the JAX layer's data-dependent init on x."""
    out, params, _ = jax.jit(lambda v: jcore.init(
        fn, jax.random.PRNGKey(0), v))(jnp.asarray(x))
    return out, params


# Channel counts that are not powers of two; odd and even kernels.
@pytest.mark.parametrize("layer", ["linear", "conv", "deconv_k3",
                                   "deconv_k4"])
def test_weight_norm_layers_init_and_forward(layer):
    """The data-dependent init (g and b from the init batch's moments, eps
    1e-10 for the linear and 1e-8 for the convs) and the output of the
    init call, then a forward of another batch with the stored g and b."""
    if layer == "linear":
        x, x2 = th.randn((6, 7), 1), th.randn((6, 7), 2)
        jfn = lambda v, init=True: jops.weight_norm_linear(  # noqa: E731
            v, 5, init=init, name="wn")
        port = ops.WeightNormLinear(7, 5)
    elif layer == "conv":
        x, x2 = th.randn((2, 6, 6, 3), 1), th.randn((2, 6, 6, 3), 2)
        jfn = lambda v, init=True: jops.weight_norm_conv2d(  # noqa: E731
            v, 5, 3, 3, 2, 2, init=init, name="wn")
        port = ops.WeightNormConv2d(3, 5, 3, 3, 2, 2)
    else:
        k = 3 if layer == "deconv_k3" else 4
        x, x2 = th.randn((2, 3, 3, 6), 1), th.randn((2, 3, 3, 6), 2)
        jfn = lambda v, init=True: jops.weight_norm_deconv2d(  # noqa: E731
            v, 5, k, k, 2, 2, init=init, name="wn")
        port = ops.WeightNormDeconv2d(6, 5, k, k, 2, 2)
    want, params = _jax_weight_norm(jfn, x)
    # The port's layer starts from the JAX direction V; g and b come from
    # the init call.
    core.assign_scopes(port, "wn")
    with torch.no_grad():
        port.V.copy_(interop.to_port(params["wn/V"]))
    got = port(torch.from_numpy(x), init=True)
    th.assert_close(got, want, RTOL, ATOL)
    for name in ("g", "b"):
        th.assert_close(getattr(port, name), params[f"wn/{name}"], RTOL,
                        ATOL, what=name)
    want2, _ = jax.jit(lambda v: jcore.apply(
        lambda u: jfn(u, init=False), params, {}, v))(jnp.asarray(x2))
    with torch.no_grad():
        th.assert_close(port(torch.from_numpy(x2)), want2, RTOL, ATOL)


# Adam with a large epsilon is linear in small gradients, so a gradient
# of rounding-noise size (EvoNorm's beta in G's first block has entries of
# ~1e-9) moves its parameter by noise, not by +-lr
# (tests/test_parallel.py:225-240).
EVONORM_CFG = """
G.batch_norm_fn = @evonorm_s0
ModularGAN.g_optimizer_fn = @AdamOptimizer
ModularGAN.d_optimizer_fn = @AdamOptimizer
AdamOptimizer.epsilon = 1e-3
"""


def test_evonorm_s0_as_g_batch_norm_fn_trains_like_jax():
    """`G.batch_norm_fn = @evonorm_s0` wires through the architecture's
    norm dispatch (tests/test_arch_ops.py:485-500): one ResNet-CIFAR step
    of the port against the JAX package's, from the same weights, batch
    and draws, held as the other step-parity tests hold the full state."""
    parameters = {"architecture": "resnet_cifar_arch", "z_dim": 8,
                  "lambda": 1, "disc_iters": 1}
    case = {"cls": "ModularGAN", "cfg": EVONORM_CFG, "dataset": "cifar10",
            "parameters": parameters}
    tgan = th.port_gan(case)
    ts_t = tgan.init_state(seed=0)
    names = ts_t.generator.jax_variables()[0]
    assert any(n.endswith("/v") for n in names), sorted(names)[:10]
    jgin.parse_config(EVONORM_CFG)
    jdatasets.set_fake_dataset(True)
    jgan = jmodular.ModularGAN(dataset=jdatasets.get_dataset("cifar10"),
                               parameters=parameters, model_dir="unused")
    ts_j = th.jax_train_state(jgan, ts_t)
    rng = np.random.RandomState(0)
    batch = {"images": rng.rand(8, 32, 32, 3).astype(np.float32),
             "labels": rng.randint(0, 10, 8).astype(np.int32)}
    draws = th.jax_draws(jgan, ts_j, batch["labels"], 4)
    ts_j, metrics_j = jax.jit(jgan.make_train_step(4))(ts_j, batch)
    ts_t, metrics_t = tgan.make_train_step(4)(ts_t, batch, draws=draws)
    # G's first layer feeds EvoNorm, whose backward removes each group's
    # mean: its gradient is a difference of terms of the largest
    # gradient's scale, so the small entries of its second moment carry
    # that scale's rounding (measured: 4e-7 of the largest).
    th.assert_train_states_close(ts_j, ts_t, metrics_j, metrics_t,
                                 lambda name: 2e-4,
                                 moment_atol=(1e-4, 1e-5))

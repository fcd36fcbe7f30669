"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Importing this module pins torch to one thread: the tests run in several
xdist workers on one host, and torch's default thread count per worker
would oversubscribe it.
"""

import numpy as np
import torch

torch.set_num_threads(1)


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
                              noise_grad=()):
    """The port's TrainState and step metrics against the JAX package's
    after the same steps. `lr_steps(name)` is the learning rate times the
    updates a parameter has taken; `noise_grad` names the parameters whose
    exact gradient is zero (a bias that feeds a batch norm directly)."""
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
            atol = (1e-4 if moment == "mu" else 1e-8) * _max_abs(want_all)
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

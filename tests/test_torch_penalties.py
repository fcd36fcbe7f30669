"""The port's gradient penalties and optimizers against the JAX package's,
f32 on the CPU.

Penalties: the value and the gradient of the penalty w.r.t. every D
parameter (a second-order gradient for WGAN-GP and DRAGAN) on the JAX
package's weights, with the JAX package's own draws of `alpha` and
`dragan_noise` handed to the port: on `dummy`, on DCGAN with batch norm in
D (second order through training-mode batch moments) and on SNDCGAN with
spectral norm (through the power iteration's sigma). Optimizers: SGD,
Momentum (with and without Nesterov), RMSProp (momentum 0 and 0.9, the
accumulator from ones) and Adam with a bf16 first moment, three steps
against optax on the same gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests import torch_helpers as th

from compare_gan_tpu import config as jgin
from compare_gan_tpu import core as jcore
from compare_gan_tpu.architectures import DISCRIMINATORS as JDISCRIMINATORS
from compare_gan_tpu.gans import penalty_lib as jpenalty
from compare_gan_tpu.ops import rng as jrng
from compare_gan_torch import config as tgin
from compare_gan_torch import core, interop
from compare_gan_torch.architectures import DISCRIMINATORS
from compare_gan_torch.gans import optimizers, penalty_lib
from compare_gan_torch.gans import consts as c

# Conv biases that feed DCGAN D's batch norms: their exact gradient is
# zero, and both sides return rounding noise of the network's scale.
BN_FED_BIASES = frozenset(f"discriminator/d_conv{i}/bias" for i in (2, 3, 4))
ARCHS = {
    # (image shape, gin of both sides)
    c.DUMMY_ARCH: ((8, 8, 3), ""),
    c.DCGAN_ARCH: ((32, 32, 3), "D.batch_norm_fn = @batch_norm\n"),
    c.SNDCGAN_ARCH: ((32, 32, 3), "D.spectral_norm = True\n"),
}


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    jgin.clear_config()
    yield
    jgin.clear_config()
    tgin.clear_config()


def _jax_penalty(arch, name, x, x_fake):
    """(params, state, value, grads w.r.t. params, draws) of the JAX
    package's penalty through its D in training mode, under one rng
    context; `draws` are its own uniform draws of that context."""
    shape, cfg = ARCHS[arch]
    jgin.parse_config(cfg)
    jdisc = JDISCRIMINATORS[arch]()
    key = jax.random.PRNGKey(5)
    _, params, state = jax.jit(lambda xx: jcore.init(
        lambda v: jdisc(v, None, is_training=True), jax.random.PRNGKey(0),
        xx))(x)

    def penalty(p):
        def d_logits_fn(xx):
            with jcore.no_state_updates():
                return jdisc(xx, None, is_training=True)[1]

        def fwd():
            with jrng.rng_context(key):
                return jpenalty.get_penalty_loss(
                    fn=getattr(jpenalty, name), d_logits_fn=d_logits_fn,
                    x=x, x_fake=x_fake,
                    d_params=jcore.filter_prefix(p, "discriminator"))

        return jcore.apply(fwd, p, state)[0]

    # Eager through DCGAN's training-mode batch norm: there the gradient
    # w.r.t. x is a small difference of large terms, and the jitted f32
    # program of XLA's CPU backend gives a WGAN-GP penalty of 1.152 where
    # JAX's eager f32, JAX's jitted f64 and the port all give 2.7528.
    grad_fn = jax.value_and_grad(penalty)
    value, grads = (grad_fn if "batch_norm" in cfg else jax.jit(grad_fn))(
        params)
    with jrng.rng_context(key):
        draws = {"alpha": jrng.uniform((x.shape[0], 1, 1, 1), name="alpha"),
                 "dragan_noise": jrng.uniform(x.shape, name="dragan_noise")}
    return params, state, value, grads, draws


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("name", ["wgangp_penalty", "dragan_penalty",
                                  "l2_penalty"])
def test_penalty_value_and_d_gradients(arch, name):
    shape, cfg = ARCHS[arch]
    x_np = np.random.RandomState(1).rand(3, *shape).astype(np.float32)
    fake_np = np.random.RandomState(2).rand(3, *shape).astype(np.float32)
    params, state, value, grads, draws = _jax_penalty(
        arch, name, jnp.asarray(x_np), jnp.asarray(fake_np))

    tgin.parse_config(cfg)
    disc = DISCRIMINATORS[arch](image_shape=shape)
    core.assign_scopes(disc, disc.name)
    th.load_jax(disc, disc.name, params, state)
    before = {k: v.clone() for k, v in disc.jax_variables()[1].items()}

    def d_logits_fn(xx):
        with core.no_state_updates():
            return disc(xx, None, is_training=True)[1]

    def draw(draw_name, draw_shape):
        got = torch.from_numpy(np.array(draws[draw_name]))
        assert tuple(got.shape) == tuple(draw_shape)
        return got

    d_params = disc.jax_variables()[0]
    got = penalty_lib.get_penalty_loss(
        fn=getattr(penalty_lib, name), d_logits_fn=d_logits_fn,
        x=torch.from_numpy(x_np), x_fake=torch.from_numpy(fake_np),
        d_params=d_params, draw=draw)
    got.backward()
    assert float(value) > 0
    # A second-order f32 gradient through up to 7 layers on two CPU
    # backends: 1e-4 relative, and each tensor's gradient within 1e-5 of
    # its largest entry (sums of terms larger than the result); a
    # BN-fed bias within 1e-5 of the network's largest gradient.
    th.assert_close(got, value, rtol=1e-4, atol=1e-6)
    largest = max(float(np.abs(np.asarray(g)).max()) for g in grads.values())
    for k, p in d_params.items():
        want = np.asarray(grads[k])
        scale = largest if k in BN_FED_BIASES else float(np.abs(want).max())
        # No gradient reaches a bias a penalty does not read: JAX's zero.
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        th.assert_close(interop.to_jax(grad), want, rtol=1e-4,
                        atol=1e-5 * scale + 1e-9, what=k)
    # The penalty's D forwards committed nothing (SN u, BN moments).
    for k, v in disc.jax_variables()[1].items():
        assert torch.equal(v, before[k]), k


def test_dragan_perturbs_in_the_input_type():
    """A bf16 x keeps the penalty's D forward in bf16: the f32 std * noise
    is cast before the add (penalty_lib.py:47-50)."""
    seen = []

    def d_logits_fn(xx):
        seen.append(xx.dtype)
        return xx.float().mean(dim=(1, 2, 3))[:, None] * 3.0

    x = torch.rand(2, 4, 4, 3).bfloat16()
    value = penalty_lib.dragan_penalty(
        d_logits_fn, x, lambda name, shape: torch.rand(shape))
    assert seen == [torch.bfloat16] and value.dtype == torch.float32


def _optax_and_port():
    return [
        ("sgd", optax.sgd(0.1), optimizers.sgd_optimizer(0.1)),
        ("momentum", optax.sgd(0.1, momentum=0.9),
         optimizers.momentum_optimizer(0.1, momentum=0.9)),
        ("nesterov", optax.sgd(0.1, momentum=0.9, nesterov=True),
         optimizers.momentum_optimizer(0.1, momentum=0.9,
                                       use_nesterov=True)),
        ("rmsprop", optax.rmsprop(0.01, decay=0.9, momentum=0.0, eps=1e-10,
                                  initial_scale=1.0),
         optimizers.rmsprop_optimizer(0.01)),
        ("rmsprop_momentum", optax.rmsprop(0.01, decay=0.9, momentum=0.9,
                                           eps=1e-10, initial_scale=1.0),
         optimizers.rmsprop_optimizer(0.01, momentum=0.9)),
        ("adam_bf16_mu", optax.adam(5e-4, b1=0.5, b2=0.9,
                                    mu_dtype=jnp.bfloat16),
         optimizers.adam_optimizer(5e-4, beta1=0.5, beta2=0.9,
                                   moment_dtype="bfloat16")),
    ]


@pytest.mark.parametrize("case", range(6), ids=[
    "sgd", "momentum", "nesterov", "rmsprop", "rmsprop_momentum",
    "adam_bf16_mu"])
def test_optimizer_matches_optax(case):
    """Three steps on gradients of decreasing scale: parameters and each
    slot of the state equal optax's (the same f32 operations in the same
    order: 1e-6 relative)."""
    name, tx, opt = _optax_and_port()[case]
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(5, 3).astype(np.float32),
              "b": rng.randn(7).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) * 10 ** -s
              for k, v in params.items()} for s in range(3)]
    p_j, state_j = dict(params), tx.init(params)
    p_t = {k: torch.tensor(v) for k, v in params.items()}
    state_t = opt.init(p_t)
    for g in grads:
        updates, state_j = tx.update(g, state_j, p_j)
        p_j = optax.apply_updates(p_j, updates)
        opt.step(p_t, {k: torch.tensor(v) for k, v in g.items()}, state_t)
    assert state_t.count == 3
    for k in params:
        th.assert_close(p_t[k], p_j[k], rtol=1e-6, atol=1e-7, what=k)
    # The port's slots beside optax's.
    leaves = {type(s).__name__: s for s in jax.tree_util.tree_leaves(
        state_j, is_leaf=lambda s: hasattr(s, "_fields"))}
    slots = {
        "momentum": [("trace", leaves.get("TraceState"), "trace")],
        "nesterov": [("trace", leaves.get("TraceState"), "trace")],
        "rmsprop": [("nu", leaves.get("ScaleByRmsState"), "nu")],
        "rmsprop_momentum": [("nu", leaves.get("ScaleByRmsState"), "nu"),
                             ("trace", leaves.get("TraceState"), "trace")],
        "adam_bf16_mu": [("mu", leaves.get("ScaleByAdamState"), "mu"),
                         ("nu", leaves.get("ScaleByAdamState"), "nu")],
    }.get(name, [])
    for field, jstate, jfield in slots:
        for k in params:
            want = getattr(jstate, jfield)[k]
            got = getattr(state_t, field)[k]
            assert str(got.dtype).split(".")[-1] == str(want.dtype), field
            th.assert_close(got, want, rtol=1e-6, atol=1e-9,
                            what=f"{field} {k}")
    if name == "rmsprop":
        assert state_t.trace == {}  # Momentum 0: the update is its own trace.


def test_rmsprop_accumulator_starts_at_ones():
    opt = optimizers.rmsprop_optimizer(0.01)
    state = opt.init({"a": torch.zeros(3)})
    assert torch.equal(state.nu["a"], torch.ones(3))


def test_tf_names_resolve_to_the_port_optimizers():
    tgin.parse_config("""
tf.train.RMSPropOptimizer.decay = 0.5
tf.train.MomentumOptimizer.use_nesterov = True
tf.train.AdamOptimizer.moment_dtype = 'bfloat16'
""")
    for ref, cls in (("tf.train.GradientDescentOptimizer",
                      optimizers.GradientDescent),
                     ("tf.train.MomentumOptimizer", optimizers.Momentum),
                     ("tf.train.RMSPropOptimizer", optimizers.RMSProp),
                     ("tf.train.AdamOptimizer", optimizers.Adam)):
        opt = tgin.get_configurable(ref)(0.1)
        assert isinstance(opt, cls), ref
    assert tgin.get_configurable("tf.train.RMSPropOptimizer")(0.1).decay \
        == 0.5
    assert tgin.get_configurable("tf.train.MomentumOptimizer")(0.1).nesterov
    adam = tgin.get_configurable("tf.train.AdamOptimizer")(0.1)
    assert adam.init({"a": torch.zeros(2)}).mu["a"].dtype == torch.bfloat16

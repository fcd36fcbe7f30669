"""The slice as a whole: one and two full BigGAN train steps of the port
against the JAX package's ModularGAN, f32 on the CPU.

32 px, small `ch`, disc_iters=2, conditional, EMA from step 0, joint G
forward for the D sub-steps and the fake-only G loss, attention in G (B2)
and D (B1). Both sides start from the JAX init_state (converted by
interop.py) and take the same batches and the same z / sampled labels,
drawn with JAX's own per-sub-step streams and handed to the port.
"""

import jax
import numpy as np
import pytest
import torch

from tests import torch_helpers as th

from compare_gan_tpu import config as jgin
from compare_gan_tpu import datasets as jdatasets
from compare_gan_tpu.gans import modular_gan as jmodular
from compare_gan_tpu.ops import pallas_attention
from compare_gan_torch import config as tgin
from compare_gan_torch import datasets, interop
from compare_gan_torch.gans import modular_gan

BATCH = 2
CFG = """
loss.fn = @hinge
penalty.fn = @no_penalty
weights.initializer = "orthogonal"
spectral_norm.singular_value = "auto"
standardize_batch.decay = 0.9
standardize_batch.epsilon = 1e-5
standardize_batch.use_moving_averages = False
ModularGAN.conditional = True
ModularGAN.g_use_ema = True
ModularGAN.ema_start_step = 0
ModularGAN.experimental_joint_gen_for_disc = True
ModularGAN.experimental_fake_only_g_loss = True
ModularGAN.g_optimizer_fn = @tf.train.AdamOptimizer
ModularGAN.d_optimizer_fn = @tf.train.AdamOptimizer
ModularGAN.g_lr = 0.0001
ModularGAN.d_lr = 0.0005
tf.train.AdamOptimizer.beta1 = 0.0
tf.train.AdamOptimizer.beta2 = 0.999
z.distribution_fn = @tf.random.normal
G.batch_norm_fn = @conditional_batch_norm
G.spectral_norm = True
D.spectral_norm = True
resnet_biggan.Generator.ch = 4
resnet_biggan.Generator.blocks_with_attention = "B2"
resnet_biggan.Discriminator.ch = 4
"""
PARAMETERS = {"architecture": "resnet_biggan_arch", "z_dim": 16,
              "lambda": 1, "disc_iters": 2}


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    pallas_attention._INTERPRET = True
    jdatasets.set_fake_dataset(True)
    datasets.set_fake_dataset(True)
    yield
    datasets.set_fake_dataset(False)
    jdatasets.set_fake_dataset(False)
    pallas_attention._INTERPRET = False
    tgin.clear_config()


def _gans(cfg=CFG):
    # The JAX side runs attention through its plain einsum reference here
    # (its CPU default); the Pallas kernel is held against the port in
    # test_torch_attention.py and test_torch_arch_ops.py.
    jgin.parse_config(cfg + "attention.use_pallas = False\n")
    tgin.parse_config(cfg)
    jgan = jmodular.ModularGAN(
        dataset=jdatasets.get_dataset("cifar10"), parameters=PARAMETERS,
        model_dir="unused")
    tgan = modular_gan.ModularGAN(
        dataset=datasets.get_dataset("cifar10"), parameters=PARAMETERS,
        model_dir="unused", device="cpu")
    return jgan, tgan


def _batch(seed):
    rng = np.random.RandomState(seed)
    total = BATCH * 3
    return {"images": rng.rand(total, 32, 32, 3).astype(np.float32),
            "labels": rng.randint(0, 10, total).astype(np.int32)}


def _one_and_two_train_steps_match_jax(cfg):
    jgan, tgan = _gans(cfg)
    # Jitted on the JAX side: eager JAX compiles op by op, which is far
    # slower than compiling the one program.
    ts_j = jax.jit(lambda key: jgan.init_state(key, BATCH))(
        jax.random.PRNGKey(0))
    ts_t = tgan.init_state(seed=1)
    interop.load_state_dict(ts_t, interop.params_from_jax(
        ts_j.params, ts_j.state, ts_j.ema_params))
    step_j = jax.jit(jgan.make_train_step(BATCH))
    step_t = tgan.make_train_step(BATCH)

    def lr_steps(name, steps):
        # One G update per step; two D sub-step updates per step.
        lr = 1e-4 if name.startswith("generator/") else 2 * 5e-4
        return lr * steps

    for step in (1, 2):
        batch = _batch(step)
        draws = th.jax_draws(jgan, ts_j, batch["labels"], BATCH)
        ts_j, metrics_j = step_j(ts_j, batch)
        ts_t, metrics_t = step_t(ts_t, batch, draws=draws)
        assert ts_t.step == int(ts_j.step) == step
        assert ts_t.disc_step == int(ts_j.disc_step) == 2 * step
        th.assert_train_states_close(ts_j, ts_t, metrics_j, metrics_t,
                                     lambda name: lr_steps(name, step),
                                     th.G_BN_FED_BIASES)


def test_one_and_two_train_steps_match_jax():
    _one_and_two_train_steps_match_jax(CFG)


def test_one_and_two_train_steps_of_the_published_g_path_match_jax():
    """As above on the path `biggan128_polygons_multiclass.gin` trains:
    G sampled anew for each D sub-step, and G's loss from D on the real
    batch as well as the fake one (both flags at their default)."""
    cfg = (CFG.replace("experimental_joint_gen_for_disc = True",
                       "experimental_joint_gen_for_disc = False")
           .replace("experimental_fake_only_g_loss = True",
                    "experimental_fake_only_g_loss = False"))
    assert cfg.count("= False") == CFG.count("= False") + 2
    _one_and_two_train_steps_match_jax(cfg)


def test_adam_matches_optax_on_the_same_gradients():
    """The port's Adam against optax.adam (optimizers.py:18-32) on the same
    parameters and gradients, three steps, beta1 = 0 as in the recipe."""
    import optax
    from compare_gan_torch.gans import optimizers

    rng = np.random.RandomState(0)
    params = {"a": rng.randn(5, 3).astype(np.float32),
              "b": rng.randn(7).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) * 10 ** -s
              for k, v in params.items()} for s in range(3)]
    tx = optax.adam(5e-4, b1=0.0, b2=0.999, eps=1e-8)
    p_j, state = dict(params), tx.init(params)
    adam = optimizers.adam_optimizer(5e-4, beta1=0.0, beta2=0.999)
    p_t = {k: torch.tensor(v) for k, v in params.items()}
    state_t = adam.init(p_t)
    for g in grads:
        updates, state = tx.update(g, state, p_j)
        p_j = optax.apply_updates(p_j, updates)
        adam.step(p_t, {k: torch.tensor(v) for k, v in g.items()}, state_t)
    for k in params:
        # Same f32 formula, one rounding apart: 1e-6 relative.
        th.assert_close(p_t[k], p_j[k], rtol=1e-6, atol=1e-7, what=k)
        th.assert_close(state_t.nu[k], state[0].nu[k], rtol=1e-6, atol=0)

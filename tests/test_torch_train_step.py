"""The slice as a whole: one and two full BigGAN train steps of the port
against the JAX package's ModularGAN, f32 on the CPU.

32 px, small `ch`, disc_iters=2, conditional, EMA from step 0, joint G
forward for the D sub-steps and the fake-only G loss, attention in G (B2)
and D (B1). Both sides start from the JAX init_state (converted by
interop.py) and take the same batches and the same z / sampled labels,
drawn with JAX's own per-sub-step streams and handed to the port. Then
one step at 64 px with the attention on G's 8x8 and D's 4x4 maps, at a
width that puts C past 64 in both.
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
from compare_gan_torch.ops import fused_attention as fa

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


def _gans(cfg=CFG, dataset="cifar10", parameters=PARAMETERS):
    # The JAX side runs attention through its plain einsum reference here
    # (its CPU default); the Pallas kernel is held against the port in
    # test_torch_attention.py and test_torch_arch_ops.py.
    jgin.parse_config(cfg + "attention.use_pallas = False\n")
    tgin.parse_config(cfg)
    jgan = jmodular.ModularGAN(
        dataset=jdatasets.get_dataset(dataset), parameters=parameters,
        model_dir="unused")
    tgan = modular_gan.ModularGAN(
        dataset=datasets.get_dataset(dataset), parameters=parameters,
        model_dir="unused", device="cpu")
    return jgan, tgan


def _batch(seed, size=32, classes=10):
    rng = np.random.RandomState(seed)
    total = BATCH * 3
    return {"images": rng.rand(total, size, size, 3).astype(np.float32),
            "labels": rng.randint(0, classes, total).astype(np.int32)}


def _lr_steps(name, steps, g_lr=1e-4, d_lr=5e-4):
    # One G update per step; two D sub-step updates per step.
    lr = g_lr if name.startswith("generator/") else 2 * d_lr
    return lr * steps


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

    for step in (1, 2):
        batch = _batch(step)
        draws = th.jax_draws(jgan, ts_j, batch["labels"], BATCH)
        ts_j, metrics_j = step_j(ts_j, batch)
        ts_t, metrics_t = step_t(ts_t, batch, draws=draws)
        assert ts_t.step == int(ts_j.step) == step
        assert ts_t.disc_step == int(ts_j.disc_step) == 2 * step
        th.assert_train_states_close(ts_j, ts_t, metrics_j, metrics_t,
                                     lambda name: _lr_steps(name, step),
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


# BigGAN at 64 px and ch 40 with the attention after G's block B1 (the 8x8
# map, 640 channels) and D's B4 (the 4x4 map, 640 channels): (C, Cg) =
# (80, 320) in both, past the 64 columns of C that the kernels hold in one
# piece, the smallest width that puts C past 64 in G and D (the SAGAN
# paper's feat8 placement, as BigGAN-128 takes it at (192, 768) and
# (96, 384) on the card). z_dim 20: the hierarchical z splits into five
# parts at 64 px.
WIDE_PARAMETERS = dict(PARAMETERS, z_dim=20)
# Learning rates of 1e-6: at the recipe's (1e-4, 5e-4) one D update at this
# width and batch sends D's hinge loss from 1.95 to 28 on the next
# sub-step in both packages, and G's Adam update then takes the other sign
# on thousands of entries (f32 gradients that part in the 4th digit near
# that point, the attention on the default blocks alike). At 1e-6 a
# parameter whose update flips moves 2e-6, inside the parameters' 1e-5, and
# the Adam moments (mu = g at beta1 = 0) hold the gradients.
WIDE_LR = 1e-6
WIDE_CFG = (CFG.replace("resnet_biggan.Generator.ch = 4",
                        "resnet_biggan.Generator.ch = 40")
            .replace('resnet_biggan.Generator.blocks_with_attention = "B2"',
                     'resnet_biggan.Generator.blocks_with_attention = "B1"')
            .replace("resnet_biggan.Discriminator.ch = 4",
                     "resnet_biggan.Discriminator.ch = 40")
            .replace("ModularGAN.g_lr = 0.0001", f"ModularGAN.g_lr = {WIDE_LR}")
            .replace("ModularGAN.d_lr = 0.0005", f"ModularGAN.d_lr = {WIDE_LR}")
            + 'resnet_biggan.Discriminator.blocks_with_attention = "B4"\n')
# G's biases that feed a batch norm (exact gradient zero) at 64 px: each
# block's conv1, and B4's conv2 and shortcut before the final norm.
WIDE_G_BN_FED_BIASES = frozenset(
    [f"generator/B{i}/up_conv1/bias" for i in range(1, 5)]
    + ["generator/B4/same_conv2/bias", "generator/B4/up_conv_shortcut/bias"])
# The Adam moments' share of the network's largest (mu, nu), twice what
# this step needs, 1.5e-3 and 1.3e-3 (G's final conv and B4's BN): G's f32
# gradients at ch 40 part by ~3e-3 of their norm between the packages, by
# 2e-3 with the attention on G's B2 and D's B1 (C 40 and 10), so it is the
# width and not the attention's C; D's need 1.2e-4 and 1.6e-6.
WIDE_MOMENT_ATOL = (3e-3, 3e-3)


def test_a_train_step_with_attention_past_c_64_matches_jax():
    """One BigGAN-64 train step with C = 80 in G's and D's non-local
    blocks against JAX's (whose einsum attention takes any C), batch 2,
    f32: losses, parameters, SN vectors and EMA at the tolerances of the
    32 px steps above, the moments at WIDE_MOMENT_ATOL. Both gates open at
    0.5, so the attention moves the losses and every gradient. The port
    initializes and interop carries its state to JAX (JAX's jitted
    orthogonal init at this width takes ~28 s on the CPU)."""
    assert WIDE_CFG.count("ch = 40") == 2 and WIDE_CFG.count('"B') == 2
    assert WIDE_CFG.count(f"_lr = {WIDE_LR}") == 2
    jgan, tgan = _gans(WIDE_CFG, "imagenet_64", WIDE_PARAMETERS)
    ts_t = tgan.init_state(seed=1)
    for module in (tgan.generator, tgan.discriminator):
        block = module.non_local_block
        assert (block.attn_ch, block.g_ch) == (80, 320)
        sigma = f"{module.name}/non_local_block/sigma"
        with torch.no_grad():
            for tree in (ts_t.params(), ts_t.ema_params):
                if sigma in tree:
                    tree[sigma].fill_(0.5)
    ts_j = th.jax_train_state(jgan, ts_t)
    batch = _batch(1, 64, 1000)
    draws = th.jax_draws(jgan, ts_j, batch["labels"], BATCH)
    ts_j, metrics_j = jax.jit(jgan.make_train_step(BATCH))(ts_j, batch)
    ts_t, metrics_t = tgan.make_train_step(BATCH)(ts_t, batch, draws=draws)
    assert ts_t.step == int(ts_j.step) == 1
    assert ts_t.disc_step == int(ts_j.disc_step) == 2
    assert set(WIDE_G_BN_FED_BIASES) <= set(ts_j.params)
    assert fa.C_CHUNK < 80  # the kernels take this C in two chunks
    th.assert_train_states_close(
        ts_j, ts_t, metrics_j, metrics_t,
        lambda name: _lr_steps(name, 1, WIDE_LR, WIDE_LR),
        WIDE_G_BN_FED_BIASES, WIDE_MOMENT_ATOL)


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

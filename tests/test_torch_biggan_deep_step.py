"""One BigGAN-deep train step of the port against the JAX package's
ModularGAN, f32 on the CPU, and checkpoints of either package loading into
the other: 64 px, ch 8, conditional, disc_iters 2, EMA from step 0, joint
G forward and fake-only G loss, attention in G after B8 (D has none at 64
px). Both sides start from the port's initial values (carried by
interop.py) and take the same batch and the same z / sampled labels, drawn
with JAX's own per-sub-step streams and handed to the port.
"""

import jax
import numpy as np
import pytest
import torch

from tests import torch_helpers as th
from tests.test_torch_biggan_deep import ARCH, RECIPE, _parse

from compare_gan_tpu import checkpoint as jckpt
from compare_gan_tpu import config as jgin
from compare_gan_tpu import datasets as jdatasets
from compare_gan_tpu.gans import modular_gan as jmodular
from compare_gan_torch import checkpoint as ckpt_lib
from compare_gan_torch import config as tgin
from compare_gan_torch import datasets, interop
from compare_gan_torch.gans import modular_gan

BATCH = 2
TRAIN_CFG = RECIPE + """
loss.fn = @hinge
penalty.fn = @no_penalty
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
"""
PARAMETERS = {"architecture": ARCH, "z_dim": 16, "lambda": 1,
              "disc_iters": 2}


@pytest.fixture(scope="module")
def stepped():
    """(jgan, tgan, ts_j, ts_t) after one train step of each package from
    the same state, on the same batch and draws: 64 px, ch 8, conditional,
    disc_iters 2, EMA from step 0, joint G forward, fake-only G loss."""
    tgin.clear_config()
    jgin.clear_config()
    for module in (datasets, jdatasets):
        module.set_fake_dataset(True)
    try:
        _parse(TRAIN_CFG)
        jgan = jmodular.ModularGAN(
            dataset=jdatasets.get_dataset("imagenet_64"),
            parameters=PARAMETERS, model_dir="unused")
        tgan = modular_gan.ModularGAN(
            dataset=datasets.get_dataset("imagenet_64"),
            parameters=PARAMETERS, model_dir="unused", device="cpu")
        ts_t = tgan.init_state(seed=1)
        with torch.no_grad():
            for tree in (ts_t.params(), ts_t.ema_params):
                tree["generator/non_local_block/sigma"].fill_(0.5)
        ts_j = th.jax_train_state(jgan, ts_t)
        rng = np.random.RandomState(1)
        batch = {"images": rng.rand(3 * BATCH, 64, 64, 3).astype(np.float32),
                 "labels": rng.randint(0, 1000, 3 * BATCH).astype(np.int32)}
        draws = th.jax_draws(jgan, ts_j, batch["labels"], BATCH)
        ts_j, metrics_j = jax.jit(jgan.make_train_step(BATCH))(ts_j, batch)
        ts_t, metrics_t = tgan.make_train_step(BATCH)(ts_t, batch,
                                                      draws=draws)
        yield jgan, tgan, ts_j, ts_t, metrics_j, metrics_t
    finally:
        for module in (datasets, jdatasets):
            module.set_fake_dataset(False)
        jgin.clear_config()
        tgin.clear_config()


# G's biases before final_conv reach the output only through batch norms,
# up to the zeros that "up" blocks interleave into their identity
# shortcuts: conv1-conv3's feed a BN directly (exact gradient zero), and
# fc_noise's and conv4's add a per-channel constant whose gradient nearly
# cancels. Their gradients are rounding-sized on both sides.
def _noise_grad(name):
    return (name.startswith("generator/") and name.endswith("/bias")
            and "final_conv" not in name)


def test_one_train_step_matches_jax(stepped):
    """Losses 1e-4, parameters 1e-5, Adam moments 1e-3 relative + 1e-4 of
    the largest, SN u 1e-4, EMA 1e-7 (tests/torch_helpers.py): the
    conventions of the BigGAN train-step test."""
    _, _, ts_j, ts_t, metrics_j, metrics_t = stepped
    assert ts_t.step == int(ts_j.step) == 1
    assert ts_t.disc_step == int(ts_j.disc_step) == 2
    noise = frozenset(k for k in ts_j.params if _noise_grad(k))
    assert "generator/B1/conv1/1x1_conv/bias" in noise

    def lr_steps(name):
        return 1e-4 if name.startswith("generator/") else 2 * 5e-4

    th.assert_train_states_close(ts_j, ts_t, metrics_j, metrics_t,
                                 lr_steps, noise)


def test_checkpoints_of_either_package_load_into_the_other(stepped,
                                                           tmp_path):
    """The JAX checkpoint after the step loads into a fresh port
    TrainState with every variable equal; the port's checkpoint holds every
    variable of the JAX TrainState under its key, in its shape, with the
    port's values."""
    _, tgan, ts_j, ts_t, _, _ = stepped
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), ts_j, 1)
    fresh = tgan.init_state(seed=5)
    with np.load(jpath) as data:
        interop.load_state_dict(fresh, {
            k: interop.to_port(data[k]) for k in data.files
            if k.startswith((".params", ".state", ".ema_params"))})
    got = interop.params_to_jax(interop.state_dict(fresh))
    for tree_got, tree_want in zip(got, (ts_j.params, ts_j.state,
                                         ts_j.ema_params)):
        assert set(tree_got) == set(tree_want)
        for name, value in tree_want.items():
            assert np.array_equal(tree_got[name], np.asarray(value)), name

    tpath = ckpt_lib.save_checkpoint(str(tmp_path / "port"), ts_t, 1)
    want = interop.params_to_jax(interop.state_dict(ts_t))
    with np.load(tpath) as data:  # Stored in the JAX layout already.
        for group, tree_j, tree_t in zip(interop.GROUPS, (
                ts_j.params, ts_j.state, ts_j.ema_params), want):
            assert set(tree_j) == set(tree_t)
            for name, value in tree_j.items():
                got = data[interop.key(group, name)]
                assert got.shape == np.shape(value), name
                assert np.array_equal(got, tree_t[name]), name

"""The self-supervised GANs against the JAX package, f32 on the CPU:
`rotate_images`, one and two Adam train steps of S3GAN and of SSGAN (each
self-supervision mode, conditional and not) on BigGAN-32 with a small `ch`
and attention in G B2 and D B1, the step's metric keys, and the refusal of
the fake-only G loss and of bad options.

Both packages start from the JAX init_state (converted by interop.py) and
take the same batches and the same z / sampled labels, drawn with JAX's own
per-sub-step streams and handed to the port. Tolerances are those of
tests/test_torch_train_step.py (torch_helpers.assert_train_states_close):
losses 1e-4, parameters 1e-5, Adam moments 1e-3 relative, SN u 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers as th

from compare_gan_tpu import config as jgin
from compare_gan_tpu import datasets as jdatasets
from compare_gan_tpu.gans import s3gan as js3gan
from compare_gan_tpu.gans import ssgan as jssgan
from compare_gan_tpu.ops import pallas_attention
from compare_gan_tpu.utils import misc as jmisc
from compare_gan_torch import config as tgin
from compare_gan_torch import datasets, interop, utils
from compare_gan_torch.gans import s3gan, ssgan

G_LR, D_LR = 1e-4, 5e-4
COMMON = """
loss.fn = @hinge
penalty.fn = @no_penalty
weights.initializer = "orthogonal"
spectral_norm.singular_value = "auto"
standardize_batch.decay = 0.9
standardize_batch.epsilon = 1e-5
standardize_batch.use_moving_averages = False
tf.train.AdamOptimizer.beta1 = 0.0
tf.train.AdamOptimizer.beta2 = 0.999
z.distribution_fn = @tf.random.normal
G.spectral_norm = True
D.spectral_norm = True
"""
# S3GAN on BigGAN-32 with the options of s3gan32_polygons_partial.gin.
S3GAN_CFG = COMMON + """
G.batch_norm_fn = @conditional_batch_norm
resnet_biggan.Generator.ch = 4
resnet_biggan.Generator.blocks_with_attention = "B2"
resnet_biggan.Discriminator.ch = 4
resnet_biggan.Discriminator.project_y = False
"""
# SSGAN with the options of ssgan32_polygons_oriented.gin on the same small
# BigGAN-32. Its published ResNet-CIFAR-32 is held to the JAX package in
# tests/test_torch_resnet_cifar.py (forward) and
# tests/test_torch_ssgan_resnet_cifar.py (two steps' gradients, under SGD):
# at those widths a step takes ~10^7 ReLU decisions, and a few
# pre-activations lie within f32 rounding (~1e-7) of zero, so the two
# packages route a gradient term differently and Adam turns it into a
# parameter difference of the order of lr. The conditional variant adds the
# class-conditional BN of G and BigGAN D's projection.
#
# The unconditional variant trains with the non-saturating loss: under the
# hinge loss, with no per-row term beside it (no projection; no rotation
# loss in mode "none"), the real and fake terms of the gradient of D's last
# conv bias cancel exactly for a channel whose pre-activations are all
# positive, and Adam turns the rounding left over into +-lr.
SSGAN_CFG = COMMON + """
loss.fn = @non_saturating
G.batch_norm_fn = @batch_norm
resnet_biggan.Generator.ch = 4
resnet_biggan.Generator.blocks_with_attention = "B2"
resnet_biggan.Generator.embed_y = False
resnet_biggan.Discriminator.ch = 4
resnet_biggan.Discriminator.project_y = False
"""
SSGAN_CONDITIONAL_CFG = COMMON + """
G.batch_norm_fn = @conditional_batch_norm
resnet_biggan.Generator.ch = 4
resnet_biggan.Generator.blocks_with_attention = "B2"
resnet_biggan.Discriminator.ch = 4
"""
TRAINER = dict(g_use_ema=True, ema_start_step=0,
               g_optimizer_fn="@tf.train.AdamOptimizer",
               d_optimizer_fn="@tf.train.AdamOptimizer", g_lr=G_LR,
               d_lr=D_LR)
S3GAN_HEADS = dict(self_supervision="rotation", rotated_batch_fraction=2,
                   project_y=True, use_predictor=True, use_soft_pred=True)


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


def _config(cfg, cls, kwargs):
    """Both packages' gin, with the trainer options bound to `cls`."""
    lines = [cfg] + [f"{cls}.{k} = {v!r}" if not str(v).startswith("@")
                     else f"{cls}.{k} = {v}" for k, v in TRAINER.items()]
    lines += [f"{cls}.{k} = {v!r}" for k, v in kwargs.items()]
    text = "\n".join(lines) + "\n"
    # The JAX side runs attention through its plain einsum reference (its
    # CPU default); the kernels are held to the port elsewhere.
    jgin.parse_config(text + "attention.use_pallas = False\n")
    tgin.parse_config(text)


def _gans(jcls, tcls, architecture, disc_iters, z_dim, conditional=True,
          **kwargs):
    params = {"architecture": architecture, "z_dim": z_dim, "lambda": 1,
              "disc_iters": disc_iters}
    jgan = jcls(dataset=jdatasets.get_dataset("cifar10"), parameters=params,
                model_dir="unused", conditional=conditional, **kwargs)
    tgan = tcls(dataset=datasets.get_dataset("cifar10"), parameters=params,
                model_dir="unused", device="cpu", conditional=conditional,
                **kwargs)
    return jgan, tgan


def _batch(seed, total, labels="hard"):
    """Images in [0, 1] and labels: "hard" class ids, "partial" with every
    third one -1 (unlabeled), "soft" rows of class probabilities with every
    third row zero (unlabeled)."""
    rng = np.random.RandomState(seed)
    batch = {"images": rng.rand(total, 32, 32, 3).astype(np.float32),
             "labels": rng.randint(0, 10, total).astype(np.int32)}
    if labels == "partial":
        batch["labels"][::3] = -1
    elif labels == "soft":
        logits = rng.randn(total, 10)
        soft = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        soft[::3] = 0.0
        batch["labels"] = soft.astype(np.float32)
    return batch


def _start(jgan, tgan, batch_size, jinit=None):
    """The JAX init_state (jitted: eager JAX compiles op by op) and the
    port's TrainState loaded from it."""
    ts_j = jax.jit(lambda key: (jinit or jgan).init_state(key, batch_size))(
        jax.random.PRNGKey(0))
    ts_t = tgan.init_state(seed=1)
    interop.load_state_dict(ts_t, interop.params_from_jax(
        ts_j.params, ts_j.state, ts_j.ema_params))
    return ts_j, ts_t


def _run_steps(jgan, tgan, ts_j, ts_t, batch_size, steps, labels="hard",
               noise_grad=th.G_BN_FED_BIASES):
    """`steps` train steps on both sides, compared after each; returns the
    last metrics of both."""
    disc_iters = jgan.num_sub_steps - 1
    step_j = jax.jit(jgan.make_train_step(batch_size))
    step_t = tgan.make_train_step(batch_size)
    for step in range(1, steps + 1):
        batch = _batch(step, batch_size * jgan.num_sub_steps, labels)
        draws = th.jax_draws(jgan, ts_j, batch["labels"], batch_size)
        ts_j, metrics_j = step_j(ts_j, batch)
        ts_t, metrics_t = step_t(ts_t, batch, draws=draws)
        assert ts_t.step == int(ts_j.step) == step

        def lr_steps(name):
            # One G update per step, disc_iters D updates (heads included).
            if name.startswith("generator/"):
                return G_LR * step
            return D_LR * disc_iters * step

        th.assert_train_states_close(ts_j, ts_t, metrics_j, metrics_t,
                                     lr_steps, noise_grad)
    return metrics_j, metrics_t


@pytest.mark.parametrize("rot90_scalars", [(0, 1, 2, 3), (1, 2, 3), (2,)])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_rotate_images_is_bitwise_the_jax_function(rot90_scalars, dtype):
    """Non-square channels and a batch of 2 catch a swapped axis or a
    rotation in the wrong direction."""
    images = th.randn((2, 5, 5, 3), seed=0)
    want = np.asarray(jmisc.rotate_images(jnp.asarray(images, dtype),
                                          rot90_scalars).astype(jnp.float32))
    got = utils.rotate_images(torch.from_numpy(images).to(
        torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32),
        rot90_scalars).float().numpy()
    assert np.array_equal(got, want)
    # One quarter-turn is jnp.rot90 over the image axes.
    quarter = utils.rotate_images(torch.from_numpy(images), (1,)).numpy()
    assert np.array_equal(quarter, np.rot90(images, 1, axes=(1, 2)))


def test_s3gan_one_and_two_train_steps_match_jax():
    """The options of s3gan32_polygons_partial.gin (rotation, projection,
    soft predictor, joint G forward, disc_iters 2) on a batch with
    unlabeled rows."""
    _config(S3GAN_CFG, "S3GAN", {"experimental_joint_gen_for_disc": True})
    jgan, tgan = _gans(js3gan.S3GAN, s3gan.S3GAN, "resnet_biggan_arch",
                       disc_iters=2, z_dim=16, **S3GAN_HEADS)
    ts_j, ts_t = _start(jgan, tgan, 8)
    heads = {k for k in ts_j.params if k.startswith("discriminator_")}
    assert heads == {
        "discriminator_rotation/score_classify/kernel",
        "discriminator_rotation/score_classify/bias",
        "discriminator_predictor/predictor_linear/kernel",
        "discriminator_predictor/predictor_linear/bias",
        "discriminator_projection/kernel"}
    assert heads <= set(ts_t.d_opt.mu)
    _, metrics_t = _run_steps(jgan, tgan, ts_j, ts_t, 8, steps=2,
                              labels="partial")
    assert 0 < metrics_t["loss/label_frac"] < 1


@pytest.mark.parametrize("self_supervision", ["rotation_gan",
                                              "rotation_only", "none"])
@pytest.mark.parametrize("conditional", [False, True])
def test_ssgan_one_and_two_train_steps_match_jax(self_supervision,
                                                 conditional):
    """BigGAN-32 at ch 4, disc_iters 2, batch 4 with 8 rotated examples (2
    per rotation): D sees 2 * (4 + 6) = 20 rows. The config's hinge loss and
    G rotation weight 0.2 are held to the JAX package on ResNet-CIFAR-32 in
    tests/test_torch_ssgan_resnet_cifar.py.

    In "rotation_only" G's weight on the rotation loss is 0 here. Its
    gradient would be the rotation CE of four rotations of each fake, whose
    terms cancel to ~1e-4 of their size at init (pooled features of a
    random D barely change when a featureless image turns), so f32 rounding
    sets its digits. With weight 0 both packages must give G exactly no
    update: the GAN terms of both losses are zeroed, as the mode says."""
    _config(SSGAN_CONDITIONAL_CFG if conditional else SSGAN_CFG, "SSGAN",
            {})
    weight_g = 0.0 if self_supervision == "rotation_only" else 0.2
    jgan, tgan = _gans(jssgan.SSGAN, ssgan.SSGAN, "resnet_biggan_arch",
                       disc_iters=2, z_dim=16, conditional=conditional,
                       self_supervision=self_supervision,
                       rotated_batch_size=8,
                       weight_rotation_loss_g=weight_g)
    ts_j, ts_t = _start(jgan, tgan, 4)
    g_before = {k: v.clone() for k, v in
                ts_t.generator.jax_variables()[0].items()}
    _run_steps(jgan, tgan, ts_j, ts_t, 4, steps=2)
    if self_supervision == "rotation_only":
        for k, v in ts_t.generator.jax_variables()[0].items():
            assert torch.equal(v, g_before[k]), k


def test_metric_keys_equal_jax():
    """The step's metrics carry each class's extra losses as loss/<key>,
    the keys of the JAX step (traced by jax.eval_shape, not run)."""
    base = {"loss/d_0", "loss/d_1", "loss/penalty", "loss/g"}
    _config(S3GAN_CFG, "S3GAN", {})
    jgan, tgan = _gans(js3gan.S3GAN, s3gan.S3GAN, "resnet_biggan_arch",
                       disc_iters=2, z_dim=16, **S3GAN_HEADS)
    batch = _batch(0, 24)
    ts_j = jax.eval_shape(lambda key: jgan.init_state(key, 8),
                          jax.random.PRNGKey(0))
    _, metrics_j = jax.eval_shape(jgan.make_train_step(8), ts_j, batch)
    _, metrics_t = tgan.make_train_step(8)(tgan.init_state(seed=0), batch)
    assert set(metrics_t) == set(metrics_j) == base | {
        "loss/rotation_real_loss", "loss/rotation_fake_loss",
        "loss/rotation_accuracy_real", "loss/class_loss_real",
        "loss/label_frac"}

    tgin.clear_config()
    tgin.parse_config(SSGAN_CFG)
    tgan = ssgan.SSGAN(dataset=datasets.get_dataset("cifar10"),
                       parameters={"architecture": "resnet_cifar_arch",
                                   "z_dim": 16, "lambda": 1,
                                   "disc_iters": 2},
                       model_dir="unused", device="cpu",
                       rotated_batch_size=8)
    _, metrics_t = tgan.make_train_step(4)(tgan.init_state(seed=0),
                                           _batch(0, 12))
    assert set(metrics_t) == base | {"loss/c_real_loss", "loss/c_fake_loss",
                                     "loss/rotation_accuracy"}


@pytest.mark.parametrize("cls,kwargs", [
    (ssgan.SSGAN, {"rotated_batch_size": 8}),
    (s3gan.S3GAN, {"rotated_batch_fraction": 2}),
])
def test_fake_only_g_loss_rejected_by_subclasses(cls, kwargs):
    """Their create_loss has no g_step, so the fake-only G loss cannot be
    honoured (tests/test_ssgan_s3gan.py has the JAX package's twin)."""
    with pytest.raises(ValueError, match="experimental_fake_only_g_loss"):
        cls(dataset=datasets.get_dataset("cifar10"),
            parameters={"architecture": "resnet_cifar_arch", "z_dim": 16,
                        "lambda": 1, "disc_iters": 1},
            model_dir="unused", device="cpu",
            experimental_fake_only_g_loss=True, **kwargs)


@pytest.mark.parametrize("kwargs,error", [
    ({"rotated_batch_fraction": None}, "rotated_batch_fraction"),
    ({"rotated_batch_fraction": 2, "use_predictor": True},
     "predictor requires projection"),
    ({"rotated_batch_fraction": 2, "self_supervision": "rotation_gan"},
     "self_supervision"),
])
def test_s3gan_refuses_bad_options(kwargs, error):
    with pytest.raises((ValueError, tgin.ConfigError), match=error):
        s3gan.S3GAN(dataset=datasets.get_dataset("cifar10"),
                    parameters={"architecture": "resnet_cifar_arch",
                                "z_dim": 16, "lambda": 1, "disc_iters": 1},
                    model_dir="unused", device="cpu", conditional=True,
                    **kwargs)


def test_unlabeled_examples_one_hot_to_zero_rows_as_in_jax():
    """A label of -1 (an unlabeled example of the partially-labeled
    polygon sets) is an all-zero row, as jax.nn.one_hot gives it; the port
    used to raise in F.one_hot."""
    _config(S3GAN_CFG, "S3GAN", {})
    jgan, tgan = _gans(js3gan.S3GAN, s3gan.S3GAN, "resnet_biggan_arch",
                       disc_iters=1, z_dim=16, **S3GAN_HEADS)
    labels = np.array([3, -1, 0, 9, -1], np.int32)
    want = np.asarray(jgan._get_one_hot_labels(jnp.asarray(labels)))
    got = tgan._get_one_hot_labels(torch.from_numpy(labels)).numpy()
    assert np.array_equal(got, want) and not want[[1, 4]].any()

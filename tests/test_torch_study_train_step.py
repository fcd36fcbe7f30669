"""Train steps of the study zoo, the port's against the JAX package's, f32
on the CPU. Both start from the JAX init_state (converted by interop.py)
and take the same batches and the same draws (z and the penalties'
`alpha` and `dragan_noise`, from JAX's own per-sub-step streams).

* ResNet5 with WGAN-GP (resnet_lsun-bedroom128.gin's recipe: Wasserstein
  loss, lambda 10, Adam 1e-4 / 0.5 / 0.9, batch norm in G) at 64 px and
  ch 4, disc_iters 2: two steps. At 32 px, 6 halvings leave the JAX D's
  last block without a pixel (NaN logits): 64 px is the smallest size.
* dummy with each penalty and each optimizer family, and the fake-only G
  loss beside a penalty (the G sub-step then computes none, as in JAX):
  two steps each.
"""

import functools

import jax
import numpy as np
import pytest

from tests import torch_helpers as th

from compare_gan_tpu import config as jgin
from compare_gan_tpu import datasets as jdatasets
from compare_gan_tpu.architectures import DISCRIMINATORS as JDISCRIMINATORS
from compare_gan_tpu.architectures import GENERATORS as JGENERATORS
from compare_gan_tpu.architectures import resnet5 as jresnet5
from compare_gan_tpu.gans import modular_gan as jmodular
from compare_gan_tpu.ops import rng as jrng
from compare_gan_torch import config as tgin
from compare_gan_torch import datasets, interop
from compare_gan_torch.architectures import DISCRIMINATORS, GENERATORS
from compare_gan_torch.architectures import resnet5
from compare_gan_torch.gans import modular_gan

BATCH = 2


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    jgin.clear_config()
    jdatasets.set_fake_dataset(True)
    datasets.set_fake_dataset(True)
    yield
    datasets.set_fake_dataset(False)
    jdatasets.set_fake_dataset(False)
    jgin.clear_config()
    tgin.clear_config()


def _gans(cfg, parameters, dataset):
    jgin.parse_config(cfg)
    tgin.parse_config(cfg)
    jgan = jmodular.ModularGAN(dataset=jdatasets.get_dataset(dataset),
                               parameters=parameters, model_dir="unused")
    tgan = modular_gan.ModularGAN(dataset=datasets.get_dataset(dataset),
                                  parameters=parameters, model_dir="unused",
                                  device="cpu")
    return jgan, tgan


def _draws(jgan, ts, labels, image_shape):
    """th.jax_draws plus each sub-step's penalty draws, under the key the
    JAX sub-step draws them with."""
    draws = th.jax_draws(jgan, ts, labels, BATCH)
    for i, d in enumerate(draws):
        key = jrng.base_key_from_step(ts.rng, ts.step, sub_step=i)
        with jrng.rng_context(key):
            d["alpha"] = np.asarray(jrng.uniform(
                (BATCH, 1, 1, 1), name="alpha"))
            d["dragan_noise"] = np.asarray(jrng.uniform(
                (BATCH,) + image_shape, name="dragan_noise"))
    return draws


def _batch(seed, shape, sub_steps):
    rng = np.random.RandomState(seed)
    total = BATCH * sub_steps
    return {"images": rng.rand(total, *shape).astype(np.float32),
            "labels": rng.randint(0, 10, total).astype(np.int32)}


def _start(jgan, tgan):
    ts_j = jax.jit(lambda key: jgan.init_state(key, BATCH))(
        jax.random.PRNGKey(0))
    ts_t = tgan.init_state(seed=1)
    interop.load_state_dict(ts_t, interop.params_from_jax(
        ts_j.params, ts_j.state, ts_j.ema_params))
    return ts_j, ts_t


RESNET5 = """
loss.fn = @wasserstein
penalty.fn = @wgangp_penalty
G.batch_norm_fn = @batch_norm
D.spectral_norm = False
standardize_batch.decay = 0.9
standardize_batch.epsilon = 1e-5
ModularGAN.g_optimizer_fn = @tf.train.AdamOptimizer
ModularGAN.g_lr = 0.0001
tf.train.AdamOptimizer.beta1 = 0.5
tf.train.AdamOptimizer.beta2 = 0.9
"""


def test_two_resnet5_wgangp_steps_match_jax(monkeypatch):
    # Both packages' architectures take `ch` from their constructor only.
    for registry, module in ((JGENERATORS, jresnet5.Generator),
                             (JDISCRIMINATORS, jresnet5.Discriminator),
                             (GENERATORS, resnet5.Generator),
                             (DISCRIMINATORS, resnet5.Discriminator)):
        monkeypatch.setitem(registry, "resnet5_arch",
                            functools.partial(module, ch=4))
    jgan, tgan = _gans(
        RESNET5,
        {"architecture": "resnet5_arch", "z_dim": 16, "lambda": 10,
         "disc_iters": 2}, "celeb_a")
    shape = (64, 64, 3)
    ts_j, ts_t = _start(jgan, tgan)
    step_j = jax.jit(jgan.make_train_step(BATCH))
    step_t = tgan.make_train_step(BATCH)
    for step in (1, 2):
        batch = _batch(step, shape, 3)
        draws = _draws(jgan, ts_j, batch["labels"], shape)
        ts_j, metrics_j = step_j(ts_j, batch)
        ts_t, metrics_t = step_t(ts_t, batch, draws=draws)
        assert float(metrics_t["loss/penalty"]) > 0
        # One G and two D Adam updates a step; the G biases that feed a
        # batch norm have an exact gradient of zero (Adam moves them by
        # +-lr on the sign of rounding noise).
        th.assert_train_states_close(
            ts_j, ts_t, metrics_j, metrics_t,
            lambda name: (1 if name.startswith("generator/") else 2)
            * 1e-4 * step,
            noise_grad={n for n in ts_j.params
                        if n.startswith("generator/") and n.endswith("bias")
                        and "final_conv" not in n})


@pytest.mark.parametrize("penalty,optimizers,fake_only", [
    ("wgangp_penalty", ("MomentumOptimizer", "RMSPropOptimizer"), False),
    ("dragan_penalty", ("GradientDescentOptimizer",
                        "GradientDescentOptimizer"), False),
    ("l2_penalty", ("RMSPropOptimizer", "MomentumOptimizer"), False),
    ("wgangp_penalty", ("AdamOptimizer", "AdamOptimizer"), True),
])
def test_dummy_steps_with_penalties_and_optimizers(penalty, optimizers,
                                                   fake_only):
    g_opt, d_opt = optimizers
    cfg = f"""
loss.fn = @wasserstein
penalty.fn = @{penalty}
ModularGAN.g_optimizer_fn = @tf.train.{g_opt}
ModularGAN.d_optimizer_fn = @tf.train.{d_opt}
ModularGAN.g_lr = 0.01
ModularGAN.d_lr = 0.05
ModularGAN.experimental_fake_only_g_loss = {fake_only}
tf.train.MomentumOptimizer.use_nesterov = True
tf.train.RMSPropOptimizer.momentum = 0.5
"""
    jgan, tgan = _gans(cfg, {"architecture": "dummy_arch", "z_dim": 8,
                             "lambda": 10, "disc_iters": 2}, "cifar10")
    shape = (32, 32, 3)
    ts_j, ts_t = _start(jgan, tgan)
    step_j = jax.jit(jgan.make_train_step(BATCH))
    step_t = tgan.make_train_step(BATCH)
    for step in (1, 2):
        batch = _batch(step, shape, 3)
        draws = _draws(jgan, ts_j, batch["labels"], shape)
        ts_j, metrics_j = step_j(ts_j, batch)
        ts_t, metrics_t = step_t(ts_t, batch, draws=draws)
        assert set(metrics_t) == set(metrics_j)
        # The other step tests' tolerances (th.assert_train_states_close):
        # losses 1e-4, parameters 1e-5; measured up to 4.5e-5 relative on
        # the losses, after updates of up to lr 0.05 carry the penalty's
        # second-order f32 rounding.
        for k in metrics_j:
            th.assert_close(metrics_t[k], metrics_j[k], rtol=1e-4,
                            atol=1e-5, what=k)
        params_t = interop.params_to_jax(interop.state_dict(ts_t))[0]
        for name, want in ts_j.params.items():
            th.assert_close(params_t[name], want, rtol=1e-4, atol=1e-5,
                            what=name)
    assert float(metrics_t["loss/penalty"]) > 0
    assert ts_t.g_opt.count == 2 and ts_t.d_opt.count == 4

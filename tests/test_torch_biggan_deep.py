"""The port's BigGAN-deep against the JAX package's: the parameter counts
of tests/test_architectures.py at 128, 256 and 512 px (built on the meta
device), G forward parity at 64 px (training and eval mode, fused and
unfused up conv; attention after B8 at C = 2, Cg = 8), D forward parity
with the projection head at 128 px (attention after B2). The train step
is held in test_torch_biggan_deep_step.py.

Weights come from the port's initializer and are carried to the JAX
package by interop.py (JAX's own init would be jitted once per test, the
slowest part of such a test on a CPU). The JAX side runs the attention
through its plain einsum reference, its CPU default; the Pallas kernel is
held against the port in test_torch_attention.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers as th

from compare_gan_tpu import config as jgin
from compare_gan_tpu import core as jcore
from compare_gan_tpu import datasets as jdatasets
from compare_gan_tpu.architectures import DISCRIMINATORS as JDISCRIMINATORS
from compare_gan_tpu.architectures import GENERATORS as JGENERATORS
from compare_gan_torch import config as tgin
from compare_gan_torch import core, datasets, interop
from compare_gan_torch import gans  # noqa: F401 (gin)
from compare_gan_torch.architectures import (DISCRIMINATORS, GENERATORS,
                                             resnet_biggan_deep)
from compare_gan_torch.gans import consts as c

ARCH = c.RESNET_BIGGAN_DEEP_ARCH
# The architecture part of example_configs/biggan_imagenet128.gin, with
# moving-average BN so that eval mode reads the training pass's moments.
RECIPE = """
weights.initializer = "orthogonal"
spectral_norm.singular_value = "auto"
standardize_batch.decay = 0.9
standardize_batch.epsilon = 1e-5
G.batch_norm_fn = @conditional_batch_norm
G.spectral_norm = True
D.spectral_norm = True
resnet_biggan_deep.Generator.ch = 8
resnet_biggan_deep.Discriminator.ch = 8
"""


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    jgin.clear_config()
    for module in (datasets, jdatasets):
        module.set_fake_dataset(True)
    yield
    for module in (datasets, jdatasets):
        module.set_fake_dataset(False)
    jgin.clear_config()
    tgin.clear_config()


def _parse(cfg):
    jgin.parse_config(cfg + "attention.use_pallas = False\n")
    tgin.parse_config(cfg)


def _jax_variables(module, gate=0.5):
    """The port module's variables in the JAX layout, keyed by JAX name,
    with the attention gate opened so that attention reaches the
    output. Copies: a JAX array may alias the numpy memory it was made
    from, which the port's forward would then update in place."""
    params, state = (
        {k: jnp.array(interop.to_jax(v), copy=True) for k, v in tree.items()}
        for tree in module.jax_variables())
    params = {k: (jnp.float32(gate) if k.endswith("non_local_block/sigma")
                  else v) for k, v in params.items()}
    th.load_jax(module, module.name, params, state)
    return params, state


@pytest.mark.parametrize("resolution,z_dim,want", [
    (128, 128, (50244484, 34590210)),
    (256, 140, (56710532, 38247426)),
    (512, 160, (58645316, 38301122)),
])
def test_golden_param_counts_on_meta(resolution, z_dim, want):
    """tests/test_architectures.py's BigGAN-deep goldens: 128 px from the
    reference's test, 256 and 512 px pinned by the JAX package; conditional
    BN in G, 1,000 classes."""
    tgin.parse_config("G.batch_norm_fn = @conditional_batch_norm\n")
    shape = (resolution, resolution, 3)
    gen = resnet_biggan_deep.Generator(image_shape=shape, z_dim=z_dim,
                                       num_classes=1000, device="meta")
    disc = resnet_biggan_deep.Discriminator(image_shape=shape,
                                            num_classes=1000, device="meta")
    assert (core.count_params(gen), core.count_params(disc)) == want
    # One attention block each, at 64x64: G after its last "up" block
    # into 64 px, D after its first "none" block at 64 px.
    assert gen._attention == 7
    assert disc._attention == {128: 1, 256: 3, 512: 5}[resolution]


@pytest.mark.parametrize("fused", [True, False])
def test_generator_forward_parity_64(fused):
    """G at 64 px, ch 8, conditional: training mode (committing the BN
    moving moments and SN u), then eval mode on those moments. The unfused
    up conv unpools, then convolves; the fused one is one conv."""
    _parse(RECIPE + f"resnet_ops.fused_scale_convs = {fused}\n")
    shape = (64, 64, 3)
    gen = GENERATORS[ARCH](image_shape=shape, z_dim=16, num_classes=10)
    core.assign_scopes(gen, gen.name)
    core.initialize(gen, gen.name, 0)
    params, state = _jax_variables(gen)
    assert "generator/B1/conv1/1x1_conv/kernel" in params
    assert "generator/B2/conv2/3x3_conv/kernel/u_var" in state
    assert "generator/non_local_block/conv2d_theta/kernel" in params
    jgen = JGENERATORS[ARCH](image_shape=shape)
    z = th.randn((3, 16), 0)
    y = np.eye(10, dtype=np.float32)[[1, 3, 7]]

    def fwd(p, s, zz, yy):
        train, s2 = jcore.apply(lambda: jgen(zz, yy, is_training=True), p, s)
        evaluated, _ = jcore.apply(lambda: jgen(zz, yy, is_training=False),
                                   p, s2)
        return train, evaluated, s2

    images, eval_images, new_state = jax.jit(fwd)(params, state, z, y)
    t_z, t_y = torch.from_numpy(z), torch.from_numpy(y)
    t_images = gen(t_z, t_y, is_training=True)
    t_eval = gen(t_z, t_y, is_training=False)
    assert tuple(t_images.shape) == (3,) + shape
    # f32 through ~45 conv/BN layers on two CPU backends (XLA, oneDNN):
    # the same sums in another order, 1e-4 relative.
    th.assert_close(t_images, images, rtol=1e-4, atol=1e-5, what="train")
    th.assert_close(t_eval, eval_images, rtol=1e-4, atol=1e-5, what="eval")
    port_state = gen.jax_variables()[1]
    assert set(port_state) == set(new_state)
    for name, value in new_state.items():
        th.assert_close(port_state[name], value, rtol=1e-4, atol=1e-5,
                        what=name)


def test_discriminator_forward_parity_128_with_projection():
    """D at 128 px, ch 8, with `project_y`: the add_channels shortcut of
    every widening block, the pool before conv4's 1x1 conv, attention
    after B2 (C = 2, Cg = 8) and the SN'd glorot-normal embedding. At 64
    px D reaches no 64x64 "none" block and has no attention."""
    _parse(RECIPE)
    shape = (128, 128, 3)
    disc = DISCRIMINATORS[ARCH](image_shape=shape, num_classes=10)
    core.assign_scopes(disc, disc.name)
    core.initialize(disc, disc.name, 0)
    params, state = _jax_variables(disc)
    assert "discriminator/B1/shortcut/add_channels/kernel" in params
    assert "discriminator/embedding_fc/kernel/u_var" in state
    assert "discriminator/non_local_block/sigma" in params
    assert not hasattr(DISCRIMINATORS[ARCH](image_shape=(64, 64, 3),
                                            num_classes=10, device="meta"),
                       "non_local_block")
    jdisc = JDISCRIMINATORS[ARCH]()
    x = np.random.RandomState(0).rand(3, 128, 128, 3).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[[2, 5, 5]]
    (prob, logits, h), new_state = jax.jit(lambda p, s, xx, yy: jcore.apply(
        lambda: jdisc(xx, yy, is_training=True), p, s))(params, state, x, y)
    t_prob, t_logits, t_h = disc(torch.from_numpy(x), torch.from_numpy(y),
                                 is_training=True)
    th.assert_close(t_h, h, rtol=1e-4, atol=1e-4, what="h")
    th.assert_close(t_logits, logits, rtol=1e-4, atol=1e-4, what="logits")
    th.assert_close(t_prob, prob, rtol=1e-4, atol=1e-5, what="prob")
    port_state = disc.jax_variables()[1]
    assert set(port_state) == set(new_state)
    for name, value in new_state.items():
        th.assert_close(port_state[name], value, rtol=1e-4, atol=1e-5,
                        what=name)

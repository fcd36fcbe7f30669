"""The port's BigGAN against the JAX package's: 128 px parameter counts
(built on the meta device, nothing allocated) and G and D forward parity at
32 px with a small `ch` on converted weights, with attention in both G
(B2) and D (B1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers as th

from compare_gan_tpu import config as jgin
from compare_gan_tpu import core as jcore
from compare_gan_tpu.architectures import resnet_biggan as jbiggan
from compare_gan_tpu.ops import pallas_attention
from compare_gan_torch import config as tgin
from compare_gan_torch import core, interop
from compare_gan_torch.architectures import resnet_biggan
from compare_gan_torch.ops import arch_ops as ops

# The architecture part of example_configs/biggan_imagenet128.gin.
RECIPE = """
weights.initializer = "orthogonal"
spectral_norm.singular_value = "auto"
standardize_batch.decay = 0.9
standardize_batch.epsilon = 1e-5
standardize_batch.use_moving_averages = False
G.batch_norm_fn = @conditional_batch_norm
G.spectral_norm = True
D.spectral_norm = True
"""


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    pallas_attention._INTERPRET = True
    yield
    pallas_attention._INTERPRET = False
    tgin.clear_config()


def test_param_counts_128_on_meta():
    """G = 70,433,988 and D = 87,982,370 (resnet_biggan.py:7-8), with the
    JAX golden test's structural checks (tests/test_architectures.py)."""
    tgin.parse_config(RECIPE)
    gen = resnet_biggan.Generator(image_shape=(128, 128, 3), z_dim=120,
                                  num_classes=1000, device="meta")
    disc = resnet_biggan.Discriminator(image_shape=(128, 128, 3),
                                       num_classes=1000, device="meta")
    assert core.count_params(gen) == 70433988
    assert core.count_params(disc) == 87982370
    assert all(p.device.type == "meta" for p in gen.parameters())
    layers_with_bias = {"fc_noise", "up_conv_shortcut", "up_conv1",
                        "same_conv2", "final_conv"}
    for name, p in gen.jax_variables()[0].items():
        parts = name.split("/")
        layer, var_name = parts[-2], parts[-1]
        if layer not in layers_with_bias:
            assert var_name != "bias", name
        if parts[-3] == "condition":
            assert var_name == "kernel" and p.shape[0] == 148, name
        if layer == "embed_y":
            assert tuple(p.shape) == (1000, 128)


def _models(cfg):
    jgin.parse_config(cfg + "attention.use_pallas = True\n")
    tgin.parse_config(cfg)
    jgen = jbiggan.Generator(image_shape=(32, 32, 3))
    jdisc = jbiggan.Discriminator()
    gen = resnet_biggan.Generator(image_shape=(32, 32, 3), z_dim=16,
                                  num_classes=10)
    disc = resnet_biggan.Discriminator(image_shape=(32, 32, 3),
                                       num_classes=10)
    return jgen, jdisc, gen, disc


def _nonzero_gates(params):
    """Attention gates start at 0; open them so attention reaches the
    output."""
    return {k: (jnp.float32(0.5) if k.endswith("non_local_block/sigma")
                else v) for k, v in params.items()}


SMALL = RECIPE + """
resnet_biggan.Generator.ch = 8
resnet_biggan.Generator.blocks_with_attention = "B2"
resnet_biggan.Discriminator.ch = 8
"""


def test_generator_and_discriminator_forward_parity_32():
    _assert_forward_parity(SMALL)


def test_discriminator_layer_norm_forward_parity_32():
    """`D.layer_norm = True` adds ln1/ln2 to each D block under the JAX
    names (resnet_biggan.py:44-55), with gamma/beta moved off their init
    values so that both reach the output."""
    _assert_forward_parity(SMALL + "D.layer_norm = True\n",
                           layer_norm=True)


def _assert_forward_parity(cfg, layer_norm=False):
    jgen, jdisc, gen, disc = _models(cfg)
    z = th.randn((4, 16), 0)
    y = np.eye(10, dtype=np.float32)[[1, 3, 3, 7]]

    def net(zz, yy):
        images = jgen(zz, yy, is_training=True)
        return images, jdisc(images, yy, is_training=True)

    # Jitted: eager JAX compiles op by op, which is slower on a CPU.
    _, params, state = jax.jit(lambda zz, yy: jcore.init(
        net, jax.random.PRNGKey(0), zz, yy))(jnp.asarray(z), jnp.asarray(y))
    params = _nonzero_gates(params)
    lns = {k for k in params if "/ln" in k}
    assert len(lns) == (16 if layer_norm else 0), sorted(lns)
    params = {k: (v * 1.5 + 0.1 if k in lns else v)
              for k, v in params.items()}
    (images, (prob, logits, h)), new_state = jax.jit(
        lambda p, s, zz, yy: jcore.apply(net, p, s, zz, yy))(
        params, state, jnp.asarray(z), jnp.asarray(y))

    for module in (gen, disc):
        core.assign_scopes(module, module.name)
        th.load_jax(module, module.name,
                    jcore.filter_prefix(params, module.name),
                    jcore.filter_prefix(state, module.name))
    assert isinstance(gen.non_local_block, ops.NonLocalBlock)
    assert isinstance(disc.non_local_block, ops.NonLocalBlock)
    t_images = gen(torch.from_numpy(z), torch.from_numpy(y), is_training=True)
    t_prob, t_logits, t_h = disc(t_images, torch.from_numpy(y),
                                 is_training=True)
    # f32 through ~15 conv/BN layers on two CPU backends: 1e-4 relative.
    th.assert_close(t_images, images, rtol=1e-4, atol=1e-5)
    th.assert_close(t_h, h, rtol=1e-4, atol=1e-4)
    th.assert_close(t_logits, logits, rtol=1e-4, atol=1e-4)
    th.assert_close(t_prob, prob, rtol=1e-4, atol=1e-5)
    # Every SN u committed by the forward (accumulator BN writes nothing
    # while training).
    port_state = {**gen.jax_variables()[1], **disc.jax_variables()[1]}
    assert set(port_state) == set(new_state)
    for name, value in new_state.items():
        th.assert_close(port_state[name], value, rtol=1e-4, atol=1e-6,
                        what=name)


def test_interop_round_trip_is_bitwise():
    rng = np.random.RandomState(0)
    params = {"generator/c/kernel": rng.randn(3, 3, 4, 5).astype(np.float32),
              "generator/c/bias": rng.randn(5).astype(np.float32)}
    state = {"generator/c/kernel/u_var": rng.randn(36, 1).astype(np.float32),
             "generator/bn/accu/update_accus": np.int32(1)}
    ema = {"generator/c/kernel": rng.randn(3, 3, 4, 5).astype(np.float32)}
    sd = interop.params_from_jax(params, state, ema)
    assert tuple(sd[".params['generator/c/kernel']"].shape) == (5, 4, 3, 3)
    back = interop.params_to_jax(sd)
    for want, got in zip((params, state, ema), back):
        assert set(want) == set(got)
        for k in want:
            assert np.array_equal(np.asarray(want[k]), got[k]), k
            assert np.asarray(want[k]).dtype == got[k].dtype, k

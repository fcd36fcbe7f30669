"""The port's study architectures (dummy, DCGAN, InfoGAN, SNDCGAN, ResNet5,
ResNet30, ResNet-STL) against the JAX package's: G then D forward parity on
the JAX package's weights at the build-and-range shapes of
tests/test_architectures.py that are not `slow`, the variable names (the
JAX scope paths), and the parameter counts of the study configurations and
of BigGAN at 256 and 512 px (built on the meta device, nothing
allocated)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers as th

from compare_gan_tpu import config as jgin
from compare_gan_tpu import core as jcore
from compare_gan_tpu import datasets as jdatasets
from compare_gan_tpu import runner_lib as jrunner
from compare_gan_tpu.architectures import DISCRIMINATORS as JDISCRIMINATORS
from compare_gan_tpu.architectures import GENERATORS as JGENERATORS
from compare_gan_torch import config as tgin
from compare_gan_torch import core, datasets, interop, runner_lib
from compare_gan_torch import gans  # noqa: F401 (gin)
from compare_gan_torch.architectures import (DISCRIMINATORS, GENERATORS,
                                             resnet_biggan)
from compare_gan_torch.gans import consts as c

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The study configs' G norm, and spectral norm in D so that its power
# iteration is held too.
RECIPE = """
G.batch_norm_fn = @batch_norm
D.spectral_norm = True
standardize_batch.decay = 0.9
standardize_batch.epsilon = 1e-5
"""
# tests/test_architectures.py's test_build_and_range and its reference
# matrix, less the `slow` cases.
SHAPES = [
    (c.DCGAN_ARCH, (64, 64, 3)), (c.DUMMY_ARCH, (32, 32, 3)),
    (c.INFOGAN_ARCH, (32, 32, 3)), (c.RESNET5_ARCH, (128, 128, 3)),
    (c.SNDCGAN_ARCH, (32, 32, 3)), (c.DCGAN_ARCH, (28, 28, 1)),
    (c.DCGAN_ARCH, (32, 32, 1)), (c.DCGAN_ARCH, (32, 32, 3)),
    (c.INFOGAN_ARCH, (28, 28, 1)), (c.INFOGAN_ARCH, (32, 32, 1)),
    (c.SNDCGAN_ARCH, (28, 28, 1)), (c.SNDCGAN_ARCH, (32, 32, 1)),
]


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


def _jax_forward(arch, shape, z, y=None):
    """(params, state, images, (prob, logits, h), new_state) of the JAX
    package's G then D on G's images, in training mode."""
    jgen = JGENERATORS[arch](image_shape=shape)
    jdisc = JDISCRIMINATORS[arch]()

    def net(zz, yy):
        images = jgen(zz, yy, is_training=True)
        return images, jdisc(images, yy, is_training=True)

    # Jitted: eager JAX compiles op by op, which is slower on a CPU.
    _, params, state = jax.jit(lambda zz: jcore.init(
        net, jax.random.PRNGKey(0), zz, y))(jnp.asarray(z))
    (images, out), new_state = jax.jit(
        lambda p, s, zz: jcore.apply(net, p, s, zz, y))(
        params, state, jnp.asarray(z))
    return params, state, images, out, new_state


def _port_modules(arch, shape, z_dim, params, state, num_classes=None):
    """The port's G and D with the JAX variables loaded (the name sets
    must be equal)."""
    gen = GENERATORS[arch](image_shape=shape, z_dim=z_dim,
                           num_classes=num_classes)
    disc = DISCRIMINATORS[arch](image_shape=shape, num_classes=num_classes)
    for module in (gen, disc):
        core.assign_scopes(module, module.name)
        th.load_jax(module, module.name,
                    jcore.filter_prefix(params, module.name),
                    jcore.filter_prefix(state, module.name))
    return gen, disc


@pytest.mark.parametrize("arch,shape", SHAPES)
def test_forward_parity(arch, shape):
    """Images in [0, 1] of the shape asked for, D's outputs and the
    committed state (BN moments, SN u) equal the JAX package's; the port
    holds the same variables under the same names."""
    jgin.parse_config(RECIPE)
    tgin.parse_config(RECIPE)
    z = th.randn((2, 120), 0)
    params, state, images, (prob, logits, h), new_state = _jax_forward(
        arch, shape, z)
    gen, disc = _port_modules(arch, shape, 120, params, state)
    assert core.count_params(gen) + core.count_params(disc) == \
        jcore.count_params(params)
    t_images = gen(torch.from_numpy(z), None, is_training=True)
    t_prob, t_logits, t_h = disc(t_images, None, is_training=True)
    assert tuple(t_images.shape) == (2,) + shape
    assert 0.0 <= t_images.min().item() <= t_images.max().item() <= 1.0
    # f32 through up to 13 conv/deconv/BN layers on two CPU backends (XLA,
    # oneDNN): the same sums in another order, 1e-4 relative.
    th.assert_close(t_images, images, rtol=1e-4, atol=1e-5, what="images")
    th.assert_close(t_h, h, rtol=1e-4, atol=1e-4, what="h")
    th.assert_close(t_logits, logits, rtol=1e-4, atol=1e-4, what="logits")
    th.assert_close(t_prob, prob, rtol=1e-4, atol=1e-5, what="prob")
    port_state = {**gen.jax_variables()[1], **disc.jax_variables()[1]}
    assert set(port_state) == set(new_state)
    for name, value in new_state.items():
        th.assert_close(port_state[name], value, rtol=1e-4, atol=1e-5,
                        what=name)


@pytest.mark.parametrize("shape", [(32, 32, 1), (32, 32, 3)])
def test_resnet5_at_32_px(shape):
    """The reference matrix's 32 px ResNet5: G matches; D's six halvings
    leave its last block a 0x0 map, where the JAX package returns NaN
    logits and the port's D refuses to be built."""
    jgin.parse_config(RECIPE)
    tgin.parse_config(RECIPE)
    z = th.randn((2, 120), 2)
    params, state, images, (_, logits, _), _ = _jax_forward(
        c.RESNET5_ARCH, shape, z)
    assert np.isnan(np.asarray(logits)).all()
    gen = GENERATORS[c.RESNET5_ARCH](image_shape=shape, z_dim=120)
    core.assign_scopes(gen, gen.name)
    th.load_jax(gen, gen.name, jcore.filter_prefix(params, gen.name),
                jcore.filter_prefix(state, gen.name))
    th.assert_close(gen(torch.from_numpy(z), None, is_training=True),
                    images, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="64 px at least"):
        DISCRIMINATORS[c.RESNET5_ARCH](image_shape=shape)


def test_dcgan_discriminator_batch_norm_forward_parity():
    """DCGAN's D with `D.batch_norm_fn = @batch_norm`, as in
    tests/test_trainer_matrix.py's penalty cases: d_bn1..d_bn3."""
    cfg = RECIPE + "D.batch_norm_fn = @batch_norm\n"
    jgin.parse_config(cfg)
    tgin.parse_config(cfg)
    z = th.randn((3, 120), 1)
    params, state, images, (prob, logits, h), new_state = _jax_forward(
        c.DCGAN_ARCH, (32, 32, 3), z)
    assert "discriminator/d_bn3/gamma" in params
    gen, disc = _port_modules(c.DCGAN_ARCH, (32, 32, 3), 120, params, state)
    t_prob, t_logits, t_h = disc(gen(torch.from_numpy(z), None, True), None,
                                 is_training=True)
    th.assert_close(t_logits, logits, rtol=1e-4, atol=1e-4)
    th.assert_close(t_h, h, rtol=1e-4, atol=1e-4)


def _jax_counts(bindings, config):
    """(G, D) parameter counts of the JAX package's init_state, shapes
    only."""
    jgin.parse_config_files_and_bindings(
        [os.path.join(REPO, "example_configs", config)], bindings)
    options = jrunner.get_options_dict()
    gan = options["gan_class"](dataset=jdatasets.get_dataset(),
                               parameters=options, model_dir="unused")
    ts = jax.eval_shape(lambda key: gan.init_state(key, 2),
                        jax.random.PRNGKey(0))
    count = lambda prefix: sum(  # noqa: E731
        int(np.prod(v.shape)) for k, v in ts.params.items()
        if k.startswith(prefix))
    return count("generator"), count("discriminator")


def _port_counts(bindings, config):
    tgin.parse_config_files_and_bindings(
        [os.path.join(REPO, "example_configs", config)], bindings)
    options = runner_lib.get_options_dict()
    gan = options["gan_class"](dataset=datasets.get_dataset(),
                               parameters=options, model_dir="unused",
                               device="meta")
    return (core.count_params(gan.generator),
            core.count_params(gan.discriminator))


@pytest.mark.parametrize("config,bindings,want", [
    ("resnet_lsun-bedroom128.gin", [], (13786115, 15086529)),
    ("sndcgan_celebahq128.gin", [], (19926019, 5983745)),
    ("dcgan_celeba64.gin", [], (5364739, 4314753)),
    ("dcgan_polygons28.gin", [], None),
    # resnet30 at its only size, 128 px, with no G norm.
    ("resnet_lsun-bedroom128.gin", [
        "options.architecture = 'resnet30_arch'", "G.batch_norm_fn = None"],
     (52176531, 53486449)),
])
def test_param_counts_of_the_study_configurations(config, bindings, want):
    """The JAX package's counts (jax.eval_shape of its init_state), equal
    to the port's; the smoke's three configurations pin theirs."""
    jax_counts = _jax_counts(bindings, config)
    if want is not None:
        assert jax_counts == want
    assert _port_counts(bindings, config) == jax_counts


def test_resnet_stl_names_and_counts():
    """ResNet-STL at its 48 px (no dataset of the registry has that size):
    the JAX package's variables, shapes only, against the port's."""
    jgin.parse_config(RECIPE)
    tgin.parse_config(RECIPE)
    shape = (48, 48, 3)
    jgen = JGENERATORS[c.RESNET_STL_ARCH](image_shape=shape)
    jdisc = JDISCRIMINATORS[c.RESNET_STL_ARCH]()

    def net(z):
        return jdisc(jgen(z, None, is_training=True), None, is_training=True)

    params = jax.eval_shape(lambda z: jcore.init(
        net, jax.random.PRNGKey(0), z)[1], jnp.zeros((2, 128)))
    gen = GENERATORS[c.RESNET_STL_ARCH](image_shape=shape, z_dim=128,
                                        device="meta")
    disc = DISCRIMINATORS[c.RESNET_STL_ARCH](image_shape=shape,
                                             device="meta")
    port = {**gen.jax_variables()[0], **disc.jax_variables()[0]}
    assert set(port) == set(params)
    for name, p in port.items():
        assert p.numel() == int(np.prod(params[name].shape)), name


@pytest.mark.parametrize("resolution,z_dim,g_att,d_att,want", [
    (256, 140, "B5", "B2", (82097604, 98635298)),
    (512, 160, "B4", "B3", (82468068, 98801378)),
])
def test_biggan_high_res_golden_counts(resolution, z_dim, g_att, d_att,
                                       want):
    """The published 256/512 counts that tests/test_architectures.py pins
    for the JAX package (resnet_biggan.py:48-62)."""
    tgin.parse_config("G.batch_norm_fn = @conditional_batch_norm\n"
                      f"resnet_biggan.Generator.blocks_with_attention = "
                      f"'{g_att}'\n"
                      f"resnet_biggan.Discriminator.blocks_with_attention = "
                      f"'{d_att}'\n")
    shape = (resolution, resolution, 3)
    gen = resnet_biggan.Generator(image_shape=shape, z_dim=z_dim,
                                  num_classes=1000, device="meta")
    disc = resnet_biggan.Discriminator(image_shape=shape, num_classes=1000,
                                       device="meta")
    assert (core.count_params(gen), core.count_params(disc)) == want


def _forward_from_port_weights(arch, shape, z, dtype=torch.float32):
    """(JAX outputs, port outputs, port outputs in f64) of G then D in
    training mode on the port's initial weights, carried to the JAX package
    (its jitted init is the slowest part of such a test on a CPU). Each
    output is (images, prob, logits, h)."""
    gen = GENERATORS[arch](image_shape=shape, z_dim=z.shape[1])
    disc = DISCRIMINATORS[arch](image_shape=shape)
    variables = {}
    for module in (gen, disc):
        core.assign_scopes(module, module.name)
        core.initialize(module, module.name, 0)
        for tree in module.jax_variables():
            variables.update({k: jnp.array(interop.to_jax(v), copy=True)
                              for k, v in tree.items()})
    params = {k: variables[k] for k in {**gen.jax_variables()[0],
                                        **disc.jax_variables()[0]}}
    state = {k: v for k, v in variables.items() if k not in params}
    jgen = JGENERATORS[arch](image_shape=shape)
    jdisc = JDISCRIMINATORS[arch]()

    def net(zz):
        images = jgen(zz, None, is_training=True)
        return (images,) + tuple(jdisc(images, None, is_training=True))

    want, _ = jax.jit(lambda p, s, zz: jcore.apply(net, p, s, zz))(
        params, state, z)
    outs = []
    for dt in (torch.float32, torch.float64):
        g, d = gen.to(dt), disc.to(dt)
        with core.no_state_updates():
            images = g(torch.from_numpy(z).to(dt), None, is_training=True)
            outs.append((images,) + tuple(d(images, None, is_training=True)))
    return want, outs[0], outs[1]


@pytest.mark.parametrize("arch,shape,images_tol", [
    # ResNet-STL at its 48 px: every output within 1e-5 of the largest.
    (c.RESNET_STL_ARCH, (48, 48, 3), 1e-5),
    # ResNet30 at its 128 px: 30 BN'd blocks whose variance is
    # E[x^2] - mean^2 in f32 on both sides. Against the port's own f64
    # forward, the port's f32 images lie 2.2e-4 of their largest entry away
    # and JAX's 8.6e-5: the two f32 results differ by their rounding, 5e-4.
    (c.RESNET30_ARCH, (128, 128, 3), 5e-4),
])
def test_forward_parity_of_resnet_stl_and_resnet30(arch, shape, images_tol):
    """G then D, training mode, batch 2 with RECIPE: the images and D's
    outputs against the JAX package's on the same weights, and both f32
    results against the port's f64 forward."""
    jgin.parse_config(RECIPE)
    tgin.parse_config(RECIPE)
    z = th.randn((2, 128), 5)
    want, got, exact = _forward_from_port_weights(arch, shape, z)
    for what, w, g, e in zip(("images", "prob", "logits", "h"), want, got,
                             exact):
        w, g, e = th.np32(w), th.np32(g), e.detach().double().numpy()
        scale = float(np.abs(e).max())
        # Images and h: of their largest entry. The logits (~1e-2 here)
        # sum h times final_fc's ~1e-2 weights; their rounding is ~1e-7.
        tol = {"images": images_tol * scale, "h": 1e-5 * scale,
               "logits": 1e-6, "prob": 1e-6}[what]
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=what)
        np.testing.assert_allclose(g, e, rtol=0, atol=tol, err_msg=what)
        np.testing.assert_allclose(w, e, rtol=0, atol=tol, err_msg=what)

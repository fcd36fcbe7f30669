"""The port's ResNet-CIFAR against the JAX package's, at its published
widths (G 256, D 128 channels): G and D forward parity on converted
weights, fused and unfused scale convs, and D's layer norm; and the
parameter counts of the two self-supervised smoke configurations (S3GAN on
BigGAN-128, SSGAN on ResNet-CIFAR-32) from the JAX package's init_state
under jax.eval_shape, equal to the port's built on the meta device."""

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
from compare_gan_tpu.architectures import resnet_cifar as jcifar
from compare_gan_tpu.gans import s3gan as js3gan  # noqa: F401 (gin)
from compare_gan_tpu.gans import ssgan as jssgan  # noqa: F401 (gin)
from compare_gan_tpu import runner_lib as jrunner
from compare_gan_torch import config as tgin
from compare_gan_torch import core, datasets, runner_lib
from compare_gan_torch.architectures import resnet_cifar
from compare_gan_torch import gans  # noqa: F401 (gin)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = """
weights.initializer = "orthogonal"
spectral_norm.singular_value = "auto"
standardize_batch.decay = 0.9
standardize_batch.epsilon = 1e-5
G.spectral_norm = True
D.spectral_norm = True
"""
VARIANTS = {
    # ssgan32_polygons_oriented.gin's architecture.
    "unconditional": """
G.batch_norm_fn = @batch_norm
""",
    "conditional": """
G.batch_norm_fn = @conditional_batch_norm
resnet_cifar.Generator.hierarchical_z = True
resnet_cifar.Generator.embed_z = True
resnet_cifar.Generator.embed_y = True
resnet_cifar.Discriminator.project_y = True
""",
    "layer_norm": """
G.batch_norm_fn = @batch_norm
D.layer_norm = True
""",
}
# S3GAN-128 in the smoke's configuration: BigGAN at ch 96 without D's own
# projection, plus the rotation, predictor and projection heads.
S3GAN_128 = ["dataset.name = 'imagenet_128'", "options.batch_size = 16",
             "S3GAN.experimental_joint_gen_for_disc = True"]
SSGAN_32 = ["dataset.name = 'cifar10'"]


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    jdatasets.set_fake_dataset(True)
    datasets.set_fake_dataset(True)
    yield
    datasets.set_fake_dataset(False)
    jdatasets.set_fake_dataset(False)
    tgin.clear_config()


@pytest.mark.parametrize("variant,fused", [
    ("unconditional", True), ("unconditional", False),
    ("conditional", True), ("layer_norm", True)])
def test_forward_parity(variant, fused):
    """G then D on G's images, in training mode, on the JAX package's
    weights, with `resnet_ops.fused_scale_convs` set alike on both sides
    (unfused once: the port's fused and unfused convs are held to each
    other below)."""
    cfg = (RECIPE + VARIANTS[variant]
           + f"resnet_ops.fused_scale_convs = {fused}\n")
    jgin.parse_config(cfg)
    tgin.parse_config(cfg)
    conditional = variant == "conditional"
    num_classes = 10 if conditional else None
    jgen = jcifar.Generator(image_shape=(32, 32, 3))
    jdisc = jcifar.Discriminator()
    gen = resnet_cifar.Generator(image_shape=(32, 32, 3), z_dim=16,
                                 num_classes=num_classes)
    disc = resnet_cifar.Discriminator(image_shape=(32, 32, 3),
                                      num_classes=num_classes)
    z = th.randn((4, 16), 0)
    y = np.eye(10, dtype=np.float32)[[1, 3, 3, 7]] if conditional else None

    def net(zz, yy):
        images = jgen(zz, yy, is_training=True)
        return images, jdisc(images, yy, is_training=True)

    jy = None if y is None else jnp.asarray(y)
    # Jitted: eager JAX compiles op by op, which is slower on a CPU.
    _, params, state = jax.jit(lambda zz, yy: jcore.init(
        net, jax.random.PRNGKey(0), zz, yy))(jnp.asarray(z), jy)
    if variant == "layer_norm":  # Move gamma/beta off their init values.
        params = {k: (v * 1.5 + 0.1 if "/ln" in k else v)
                  for k, v in params.items()}
    (images, (prob, logits, h)), new_state = jax.jit(
        lambda p, s, zz, yy: jcore.apply(net, p, s, zz, yy))(
        params, state, jnp.asarray(z), jy)

    for module in (gen, disc):
        core.assign_scopes(module, module.name)
        th.load_jax(module, module.name,
                    jcore.filter_prefix(params, module.name),
                    jcore.filter_prefix(state, module.name))
    ty = None if y is None else torch.from_numpy(y)
    t_images = gen(torch.from_numpy(z), ty, is_training=True)
    t_prob, t_logits, t_h = disc(t_images, ty, is_training=True)
    # f32 through ~20 conv/BN layers of 128-256 channels on two CPU
    # backends: 1e-4 relative.
    th.assert_close(t_images, images, rtol=1e-4, atol=1e-5)
    th.assert_close(t_h, h, rtol=1e-4, atol=1e-4)
    th.assert_close(t_logits, logits, rtol=1e-4, atol=1e-4)
    th.assert_close(t_prob, prob, rtol=1e-4, atol=1e-5)
    port_state = {**gen.jax_variables()[1], **disc.jax_variables()[1]}
    assert set(port_state) == set(new_state)
    for name, value in new_state.items():
        th.assert_close(port_state[name], value, rtol=1e-4, atol=1e-5,
                        what=name)


def test_fused_and_unfused_scale_convs_agree():
    """The fused up/down convs compute conv2d(unpool(x)) and
    avg_pool(conv2d(x)) exactly, up to f32 summation order, on one set of
    weights."""
    outputs = []
    for fused in (True, False):
        tgin.clear_config()
        tgin.parse_config(RECIPE + VARIANTS["unconditional"]
                          + f"resnet_ops.fused_scale_convs = {fused}\n")
        gen = resnet_cifar.Generator(image_shape=(32, 32, 3), z_dim=16)
        disc = resnet_cifar.Discriminator(image_shape=(32, 32, 3))
        for module in (gen, disc):
            core.assign_scopes(module, module.name)
            core.initialize(module, module.name, 0)
        images = gen(torch.from_numpy(th.randn((2, 16), 0)), None,
                     is_training=True)
        outputs.append((images,) + disc(images, None, is_training=True))
    names = ("images", "prob", "logits", "h")
    for name, fused_out, unfused_out in zip(names, *outputs):
        th.assert_close(fused_out, unfused_out, rtol=1e-5, atol=1e-5,
                        what=name)


def _jax_counts(bindings, config):
    """(G, D with its heads) parameter counts of the JAX package's
    init_state, shapes only."""
    jgin.parse_config_files_and_bindings(
        [os.path.join(REPO, "example_configs", config)], bindings)
    options = jrunner.get_options_dict()
    gan = options["gan_class"](dataset=jdatasets.get_dataset(),
                               parameters=options, model_dir="unused")
    batch_size = options["batch_size"]
    ts = jax.eval_shape(lambda key: gan.init_state(key, batch_size),
                        jax.random.PRNGKey(0))
    g = sum(int(np.prod(v.shape)) for k, v in ts.params.items()
            if k.startswith("generator"))
    d = sum(int(np.prod(v.shape)) for k, v in ts.params.items()
            if k.startswith("discriminator"))
    assert g + d == sum(int(np.prod(v.shape)) for v in ts.params.values())
    return g, d


def _port_counts(bindings, config):
    tgin.parse_config_files_and_bindings(
        [os.path.join(REPO, "example_configs", config)], bindings)
    options = runner_lib.get_options_dict()
    gan = options["gan_class"](dataset=datasets.get_dataset(),
                               parameters=options, model_dir="unused",
                               device="meta")
    return (core.count_params(gan.generator),
            core.count_params(gan.discriminator)
            + core.count_params(gan.heads))


@pytest.mark.parametrize("bindings,config,want", [
    (S3GAN_128, "s3gan32_polygons_partial.gin", (70433988, 89525518)),
    (SSGAN_32, "ssgan32_polygons_oriented.gin", (5849603, 1483653)),
])
def test_param_counts_of_the_smoke_configurations(bindings, config, want):
    """The counts chip_smoke.py pins: G, and D plus its heads."""
    assert _jax_counts(bindings, config) == want
    assert _port_counts(bindings, config) == want

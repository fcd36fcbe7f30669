"""The port's demo (compare_gan_torch/demo.py, counterpart of
examples/demo.py) and its module loaders, f32 on the CPU: the cases of
tests/test_demo.py on the port's demo, the interpolation's end frames, and
the port's `load_generator` / `load_discriminator` on an export written by
the JAX package against the JAX package's loaders, labels outside
[0, num_classes) included (all-zero rows, as jax.nn.one_hot makes them).

The JAX side runs attention through its plain einsum reference (its CPU
default)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests import torch_helpers as th

from compare_gan_tpu import config as jgin
from compare_gan_tpu import datasets as jdatasets
from compare_gan_tpu import export as jexport
from compare_gan_tpu.gans import modular_gan as jmodular
from compare_gan_torch import config as tgin
from compare_gan_torch import datasets, demo, export
from compare_gan_torch.gans import modular_gan
from compare_gan_torch.tf_io import image_codec

# BigGAN-32 at ch 4 with attention at G's B2 (tests/test_torch_eval.py).
BIGGAN = """
weights.initializer = "orthogonal"
spectral_norm.singular_value = "auto"
standardize_batch.decay = 0.9
standardize_batch.epsilon = 1e-5
standardize_batch.use_moving_averages = False
ModularGAN.conditional = True
ModularGAN.g_use_ema = True
z.distribution_fn = @tf.random.normal
G.batch_norm_fn = @conditional_batch_norm
G.spectral_norm = True
D.spectral_norm = True
resnet_biggan.Generator.ch = 4
resnet_biggan.Generator.blocks_with_attention = "B2"
resnet_biggan.Discriminator.ch = 4
attention.use_pallas = False
"""
# f32 G and D forwards of ~15 conv/BN layers on two CPU backends, as in
# tests/test_torch_eval.py.
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _fake_data():
    for module in (datasets, jdatasets):
        module.set_fake_dataset(True)
    tgin.clear_config()
    yield
    for module in (datasets, jdatasets):
        module.set_fake_dataset(False)
    tgin.clear_config()


@pytest.fixture(scope="module")
def jax_export(tmp_path_factory):
    """A module export written by the JAX package: BigGAN-32 with its
    attention gates opened and filled BN accumulators."""
    jdatasets.set_fake_dataset(True)
    try:
        jgin.parse_config(BIGGAN)
        gan = jmodular.ModularGAN(
            dataset=jdatasets.get_dataset("cifar10"), model_dir="unused",
            parameters={"architecture": "resnet_biggan_arch", "z_dim": 16,
                        "lambda": 1})
        ts = jax.jit(lambda key: gan.init_state(key, 4))(
            jax.random.PRNGKey(0))

        def gated(tree):
            return {k: (jnp.float32(0.5) if k.endswith(
                "non_local_block/sigma") else v) for k, v in tree.items()}

        ts = dataclasses.replace(
            ts, params=gated(ts.params), ema_params=gated(ts.ema_params),
            state=th.filled_accumulators(ts.state, 2))
        d = str(tmp_path_factory.mktemp("jax_export"))
        jexport.export_module(gan, ts, d)
    finally:
        jdatasets.set_fake_dataset(False)
    return d


def _port_export(tmp_path, bindings=""):
    """tests/test_demo.py's export (dummy_arch, conditional, z_dim 8), by
    the port, with `bindings` in its gin snapshot."""
    if bindings:
        tgin.parse_config(bindings)
    gan = modular_gan.ModularGAN(
        dataset=datasets.get_dataset("cifar10"), model_dir=str(tmp_path),
        parameters={"architecture": "dummy_arch", "z_dim": 8, "lambda": 1},
        conditional=True, device="cpu")
    d = str(tmp_path / "tfhub" / "1")
    export.export_module(gan, gan.init_state(seed=0), d)
    return d


def _fresh_spec(d):
    """The export's spec as a fresh process sees it: an empty live
    config."""
    tgin.clear_config()
    return export.load_generator(d, device="cpu")[1]


def test_sample_z_honors_export_normal_binding(tmp_path):
    d = _port_export(tmp_path, "z.distribution_fn = @tf.random.normal")
    z = demo._sample_z(_fresh_spec(d), 64, seed=0)
    assert z.dtype == np.float32 and z.shape == (64, 8)
    assert np.abs(z).max() > 1.0
    assert abs(float(z.std()) - 1.0) < 0.15


def test_sample_z_partial_eval_scope_override(tmp_path):
    """A snapshot binding only eval_z.stddev selects the eval_z scope,
    whose default distribution is uniform."""
    d = _port_export(tmp_path, "z.distribution_fn = @tf.random.normal\n"
                               "eval_z.stddev = 2.0")
    z = demo._sample_z(_fresh_spec(d), 64, seed=0)
    assert np.abs(z).max() <= 1.0


def test_sample_z_default_uniform(tmp_path):
    z = demo._sample_z(_fresh_spec(_port_export(tmp_path)), 64, seed=0)
    assert np.abs(z).max() <= 1.0


def _png(path):
    with open(path, "rb") as f:
        return image_codec.decode_png(f.read())


def test_demo_main_per_class_grid(tmp_path, jax_export):
    """The CLI on the JAX package's export: one grid row per class
    (cifar10: 10 classes of 32 px), a one-row interpolation, and finite D
    predictions."""
    out = str(tmp_path / "out")
    result = demo.main([f"--export_dir={jax_export}", f"--out_dir={out}",
                        "--per_class_grid", "--num_cols=3",
                        "--num_interps=2", "--device=cpu"])
    grid = _png(os.path.join(out, "samples.png"))
    assert grid.shape == (10 * 32, 3 * 32, 3)
    np.testing.assert_array_equal(
        grid[32:64, :32], np.clip(result["samples"][3] * 255.0, 0, 255
                                  ).astype(np.uint8))
    assert _png(os.path.join(out, "interpolation.png")).shape == (
        32, 2 * 32, 3)
    assert result["predictions"].shape == (4,)
    assert np.isfinite(result["predictions"]).all()


def test_interpolation_ends_are_the_end_latents(jax_export):
    generate, spec = export.load_generator(jax_export, device="cpu")
    z_a, z_b = demo._sample_z(spec, 2, seed=5)
    labels = np.full(5, 7, np.int32)
    frames = demo.interpolate(generate, z_a, z_b, labels, 5)
    assert frames.shape == (5, 32, 32, 3)
    # Batches of 5 and of 1 through eval-mode G: the same f32 arithmetic
    # per example, grouped differently by oneDNN.
    for frame, z in ((frames[0], z_a), (frames[-1], z_b)):
        th.assert_close(frame, generate(z[None], labels[:1])[0],
                        rtol=1e-5, atol=1e-6)
    assert not np.allclose(frames[0], frames[-1], atol=1e-3)


def test_discriminator_on_a_jax_export_matches_the_jax_loader(jax_export):
    """The demo's D cell: random images with random labels, through the
    port's load_discriminator and the JAX package's."""
    rng = np.random.RandomState(23)
    images = rng.random_sample((4, 32, 32, 3)).astype(np.float32)
    labels = rng.randint(0, 10, size=4).astype(np.int32)
    disc_t, _ = export.load_discriminator(jax_export, device="cpu")
    disc_j, _ = jexport.load_discriminator(jax_export)
    for got, want in zip(disc_t(images, labels), disc_j(images, labels)):
        th.assert_close(got, want, RTOL, 1e-4)


def test_labels_outside_the_classes_are_zero_rows(jax_export):
    """-1 and num_classes condition on an all-zero row in both packages'
    loaders (the port's used to raise on them); a conditional export still
    needs labels."""
    labels = np.array([-1, 3, 10], np.int32)
    z = th.randn((3, 16), 4)
    gen_t, spec = export.load_generator(jax_export, device="cpu")
    gen_j, _ = jexport.load_generator(jax_export)
    images = gen_t(z, labels)
    th.assert_close(images, gen_j(z, labels), RTOL, ATOL)
    # -1 and 10 give the same (zero-row) image for the same z.
    th.assert_close(gen_t(z[:1], labels[2:]), images[:1], 0, 1e-6)
    disc_t, _ = export.load_discriminator(jax_export, device="cpu")
    disc_j, _ = jexport.load_discriminator(jax_export)
    for got, want in zip(disc_t(images, labels),
                         disc_j(th.np32(images), labels)):
        th.assert_close(got, want, RTOL, 1e-4)
    for fn, x in ((gen_t, z), (disc_t, th.np32(images))):
        with pytest.raises(ValueError, match="needs labels"):
            fn(x)

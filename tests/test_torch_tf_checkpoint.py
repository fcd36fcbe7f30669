"""Reference TF checkpoints in and out of the port, without TensorFlow
(compare_gan_torch/tf_io/checkpoint_bundle.py, export.py).

* A checkpoint written by the JAX package's `export_reference_checkpoint`
  (a TF Saver) imports through the port bitwise equal to
  `interop.params_from_jax` of the JAX importer's TrainState, for
  conditional BigGAN-32 with EMA and for ResNet-CIFAR; G's forward on the
  imported weights is then held to the JAX package's at 1e-4 relative to
  the images' largest magnitude (f32, the same arithmetic in another order,
  as the port's BigGAN-32 forward tests hold it).
* The port's export of the imported TrainState loads bitwise in
  `tf.train.load_checkpoint`, in a Saver and in the JAX importer; a TF-Hub
  module dir and a model_dir's pointer resolve.
* A missing variable raises the JAX package's error, diff and all.

The JAX side's init runs jitted (the JAX importer builds its template with
`init_state` too): eager JAX compiles op by op, far slower on the CPU.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers as th

from compare_gan_tpu import config as jgin
from compare_gan_tpu import datasets as jdatasets
from compare_gan_tpu import export as jexport
from compare_gan_tpu.gans.modular_gan import ModularGAN as JModularGAN
from compare_gan_torch import config as tgin
from compare_gan_torch import datasets, eval_utils, export, interop
from compare_gan_torch.gans.modular_gan import ModularGAN
from compare_gan_torch.tf_io import checkpoint_bundle

tf = pytest.importorskip("tensorflow")

CASES = {
    "biggan32_conditional_ema": (
        "G.spectral_norm = True\nD.spectral_norm = True\n"
        "G.batch_norm_fn = @conditional_batch_norm\n"
        "resnet_biggan.Generator.ch = 8\n"
        "resnet_biggan.Discriminator.ch = 8\n",
        "resnet_biggan_arch", True, 120),
    "resnet_cifar_ema": (
        "G.batch_norm_fn = @batch_norm\nD.spectral_norm = True\n",
        "resnet_cifar_arch", False, 128),
}
# f32 images of the same weights through two implementations.
FORWARD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    for mod in (datasets, jdatasets):
        mod.set_fake_dataset(True)
    yield
    for mod in (datasets, jdatasets):
        mod.set_fake_dataset(False)
    eval_utils.set_inception_fn(None)
    tgin.clear_config()


def _gans(case, tmp_path):
    cfg, arch, conditional, z_dim = CASES[case]
    jgin.parse_config(cfg)
    tgin.parse_config(cfg)
    parameters = {"architecture": arch, "z_dim": z_dim, "lambda": 1,
                  "disc_iters": 1}
    kwargs = dict(parameters=parameters, model_dir=str(tmp_path),
                  conditional=conditional, g_use_ema=True)
    jgan = JModularGAN(dataset=jdatasets.get_dataset("cifar10"), **kwargs)
    jgan.init_state = jax.jit(jgan.init_state, static_argnums=1)
    tgan = ModularGAN(dataset=datasets.get_dataset("cifar10"),
                      device="cpu", **kwargs)
    return jgan, tgan


def _jax_state(jgan, seed):
    """A JAX TrainState whose state and EMA differ from a fresh init:
    positive BN variances and counters, EMA shadows off the params."""
    ts = jgan.init_state(jax.random.PRNGKey(seed), 2)
    rng = np.random.RandomState(seed)

    def noisy(v, name=""):
        v = np.asarray(v, np.float32)
        if name.endswith(("variance", "counter")):
            return jnp.asarray(np.abs(v) + rng.rand(*v.shape).astype(
                np.float32) + 0.5)
        return jnp.asarray(v + 0.01 * rng.randn(*v.shape).astype(np.float32))

    return dataclasses.replace(
        ts, state={k: noisy(v, k) for k, v in ts.state.items()},
        ema_params={k: noisy(v) for k, v in ts.ema_params.items()},
        step=jnp.asarray(9, jnp.int32), disc_step=jnp.asarray(18, jnp.int32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_written_checkpoint_imports_bitwise(case, tmp_path):
    jgan, tgan = _gans(case, tmp_path)
    prefix = jexport.export_reference_checkpoint(
        jgan, _jax_state(jgan, 3), str(tmp_path / "ref" / "model.ckpt-9"))
    ts_j = jexport.import_reference_checkpoint(jgan, prefix, batch_size=2)
    # Through the model_dir's pointer, as a user would pass it.
    ts_t = export.import_reference_checkpoint(tgan, str(tmp_path / "ref"))

    assert (ts_t.step, ts_t.disc_step) == (9, 18) == (
        int(ts_j.step), int(ts_j.disc_step))
    want = interop.params_from_jax(ts_j.params, ts_j.state, ts_j.ema_params)
    got = interop.state_dict(ts_t)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k].detach(), v), k

    cfg, arch, conditional, z_dim = CASES[case]
    z = th.randn((3, z_dim), 5)
    labels = np.array([1, 7, 4], np.int32) if conditional else None
    images_j, _ = jax.jit(jgan.sample)(
        ts_j, jnp.asarray(z), None if labels is None else jnp.asarray(labels))
    images_t = tgan.sample(ts_t, torch.from_numpy(z), None if labels is None
                           else torch.from_numpy(labels))
    images_j = np.asarray(images_j)
    assert images_t.shape == images_j.shape
    scale = float(np.abs(images_j).max())
    th.assert_close(images_t, images_j, 0, FORWARD_RTOL * scale,
                    "G forward on imported weights")

    _check_port_export(jgan, tgan, ts_t, tmp_path)
    _check_missing_variable(jgan, tgan, ts_t, tmp_path)


def _check_port_export(jgan, tgan, ts, tmp_path):
    """The port's export loads bitwise in TensorFlow (reader and a Saver
    built in code: no .meta needed) and in the JAX importer."""
    ts.step, ts.disc_step = 11, 22
    prefix = export.export_reference_checkpoint(
        tgan, ts, str(tmp_path / "out" / "model.ckpt-11"))
    assert sorted(os.listdir(tmp_path / "out")) == [
        "checkpoint", "model.ckpt-11.data-00000-of-00001",
        "model.ckpt-11.index"]
    assert tf.train.latest_checkpoint(str(tmp_path / "out")) == prefix

    reader = tf.train.load_checkpoint(prefix)
    want = {**{k: interop.to_jax(v) for tree in (ts.params(), ts.state())
               for k, v in tree.items()},
            **{k + "/ExponentialMovingAverage": interop.to_jax(v)
               for k, v in ts.ema_params.items()}}
    assert set(reader.get_variable_to_shape_map()) == set(want) | {
        "global_step", "global_step_disc"}
    for k, v in want.items():
        got = reader.get_tensor(k)
        assert got.dtype == np.float32 and got.shape == v.shape, k
        np.testing.assert_array_equal(got, v, err_msg=k)
    assert reader.get_tensor("global_step").dtype == np.int64
    assert int(reader.get_tensor("global_step")) == 11
    assert reader.get_tensor("global_step_disc").dtype == np.int32
    assert int(reader.get_tensor("global_step_disc")) == 22

    name = sorted(ts.params())[0]
    graph = tf.Graph()
    with graph.as_default():
        var = tf.compat.v1.get_variable(name, shape=want[name].shape)
        saver = tf.compat.v1.train.Saver([var])
        with tf.compat.v1.Session(graph=graph) as sess:
            saver.restore(sess, prefix)
            np.testing.assert_array_equal(sess.run(var), want[name])

    ts_j = jexport.import_reference_checkpoint(jgan, prefix, batch_size=2)
    for k, v in ts_j.ema_params.items():
        np.testing.assert_array_equal(np.asarray(v), want[
            k + "/ExponentialMovingAverage"], err_msg=k)
    assert int(ts_j.step) == 11 and int(ts_j.disc_step) == 22


def _check_missing_variable(jgan, tgan, ts, tmp_path):
    """One variable dropped and one added: both importers raise the same
    error with the same diff."""
    tensors = {k: interop.to_jax(v) for tree in (ts.params(), ts.state())
               for k, v in tree.items()}
    tensors.update({k + "/ExponentialMovingAverage": interop.to_jax(v)
                    for k, v in ts.ema_params.items()})
    dropped = sorted(ts.params())[3]
    del tensors[dropped]
    tensors["generator/extra/kernel"] = np.zeros(2, np.float32)
    prefix = checkpoint_bundle.write_checkpoint(
        str(tmp_path / "m" / "model.ckpt-1"), tensors)
    with pytest.raises(ValueError) as mine:
        export.import_reference_checkpoint(tgan, prefix)
    with pytest.raises(ValueError) as ref:
        jexport.import_reference_checkpoint(jgan, prefix, batch_size=2)
    assert str(mine.value) == str(ref.value)
    assert f"Missing: ['{dropped}']" in str(mine.value)
    assert "Extra: ['generator/extra/kernel']" in str(mine.value)


def test_bundle_tables_of_many_blocks_and_hub_dirs(tmp_path):
    """Thousands of entries span several table blocks; names under
    `module/` in `<dir>/variables/variables` are a TF-Hub module; dtypes
    other than f32 keep their type."""
    rng = np.random.RandomState(0)
    tensors = {f"module/generator/layer_{i:04d}/kernel":
               rng.randn(2, i % 5 + 1).astype(np.float32)
               for i in range(3000)}
    tensors.update({"module/h": rng.randn(3).astype(np.float16),
                    "module/i": np.arange(5, dtype=np.int32),
                    "module/d": rng.randn(2, 2)})
    hub = tmp_path / "hub"
    prefix = checkpoint_bundle.write_checkpoint(
        str(hub / "variables" / "variables"), tensors)
    assert checkpoint_bundle.resolve_checkpoint(str(hub)) == prefix
    with open(prefix + ".index", "rb") as f:
        assert len(checkpoint_bundle.read_table(f.read())) == 3004
    reader = tf.train.load_checkpoint(prefix)
    mine = checkpoint_bundle.CheckpointReader(prefix)
    assert mine.variable_to_shape_map() == {
        k: tuple(v) for k, v in reader.get_variable_to_shape_map().items()}
    for k, v in tensors.items():
        for got in (reader.get_tensor(k), mine.get_tensor(k)):
            assert got.dtype == v.dtype
            np.testing.assert_array_equal(got, v)
    assert export.classify_tf_variable(
        "module/generator/layer_0001/kernel") == (
            "param", "generator/layer_0001/kernel")


def test_corrupt_bytes_are_refused(tmp_path):
    prefix = checkpoint_bundle.write_checkpoint(
        str(tmp_path / "c" / "model.ckpt-1"),
        {"a": np.arange(300, dtype=np.float32)})
    data_path = prefix + ".data-00000-of-00001"
    raw = bytearray(open(data_path, "rb").read())
    raw[100] ^= 1
    open(data_path, "wb").write(bytes(raw))
    with pytest.raises(checkpoint_bundle.CheckpointError, match="checksum"):
        checkpoint_bundle.CheckpointReader(prefix).get_tensor("a")

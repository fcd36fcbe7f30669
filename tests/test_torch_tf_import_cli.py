"""The import CLI, `python -m compare_gan_torch.import_tf_checkpoint`, as
the README gives the flow: a reference-shaped ResNet-CIFAR checkpoint (the
JAX package's Saver export) becomes the port's npz checkpoint and operative
config, and continuous_eval then scores it on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.helpers import fake_inception

from compare_gan_tpu import config as jgin
from compare_gan_tpu import datasets as jdatasets
from compare_gan_tpu import export as jexport
from compare_gan_tpu.gans.modular_gan import ModularGAN as JModularGAN
from compare_gan_torch import config as tgin
from compare_gan_torch import datasets, eval_utils, main
from compare_gan_torch import import_tf_checkpoint

pytest.importorskip("tensorflow")


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


CLI_GIN = """
dataset.name = "cifar10"
options.gan_class = @ModularGAN
options.architecture = "resnet_cifar_arch"
options.batch_size = 8
options.training_steps = 77
options.disc_iters = 1
options.z_dim = 16
options.lamba = 1
loss.fn = @non_saturating
penalty.fn = @no_penalty
G.batch_norm_fn = @batch_norm
D.spectral_norm = True
"""


def test_import_cli_then_continuous_eval(tmp_path):
    """The README flow: a reference-shaped checkpoint (written by the JAX
    package's Saver export) through `python -m
    compare_gan_torch.import_tf_checkpoint`, then continuous_eval of the
    imported model_dir, on the CPU."""
    gin_file = tmp_path / "model.gin"
    gin_file.write_text(CLI_GIN)
    jgin.parse_config(CLI_GIN)
    jgan = JModularGAN(dataset=jdatasets.get_dataset("cifar10"),
                       parameters={"architecture": "resnet_cifar_arch",
                                   "z_dim": 16, "lambda": 1,
                                   "disc_iters": 1},
                       model_dir=str(tmp_path))
    ts_j = jax.jit(jgan.init_state, static_argnums=1)(
        jax.random.PRNGKey(1), 2)
    ts_j = dataclasses.replace(ts_j, step=jnp.asarray(77, jnp.int32))
    jexport.export_reference_checkpoint(
        jgan, ts_j, str(tmp_path / "ref" / "model.ckpt-77"))

    model_dir = tmp_path / "imported"
    path = import_tf_checkpoint.main([
        f"--checkpoint={tmp_path / 'ref'}", f"--model_dir={model_dir}",
        f"--gin_config={gin_file}", "--batch_size=2", "--device=cpu"])
    assert path == str(model_dir / "model.ckpt-77.npz")
    assert (model_dir / "operative_config-77.gin").exists()
    with np.load(path) as ckpt:
        assert int(ckpt[".step"]) == 77
        for k, v in ts_j.params.items():
            np.testing.assert_array_equal(ckpt[f".params['{k}']"],
                                          np.asarray(v), err_msg=k)

    (model_dir / "TRAIN_DONE").write_text("")
    eval_utils.set_inception_fn(fake_inception)
    tgin.clear_config()
    report = main.main([
        f"--model_dir={model_dir}", "--schedule=continuous_eval",
        f"--gin_config={gin_file}", "--data_fake_dataset", "--device=cpu",
        "--num_eval_averaging_runs=1", "--eval_every_steps=77"])
    assert [r["step"] for r in report.evals] == [77]
    rows = (model_dir / "scores.csv").read_text().splitlines()
    header = rows[0].split(",")
    row = dict(zip(header, rows[1].split(",")))
    fid = float(row["fid_score_mean"])
    assert np.isfinite(fid) and fid != 31337.0

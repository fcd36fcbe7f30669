"""The study configs through the port's CLI on the CPU:
dcgan_polygons28.gin (with RMSProp for G and Nesterov momentum for D) and
resnet_lsun-bedroom128.gin (ResNet5 with WGAN-GP, D sub-steps 5, at ch 4)
train 2 steps on fake data, and 2 steps in one run equal 1 step, a
restart and 1 more, bitwise, checkpoints included (the optimizers' slots
under the port's keys). eval_after_train scores the DCGAN checkpoint,
whose G normalizes by moving averages (no accumulators), and its export
loads in the JAX package."""

import csv
import functools
import os

import numpy as np
import pytest

from tests import torch_helpers as th
from tests.helpers import fake_inception

from compare_gan_tpu import export as jexport
from compare_gan_torch import config as tgin
from compare_gan_torch import datasets, eval_utils, export, main
from compare_gan_torch.architectures import DISCRIMINATORS, GENERATORS
from compare_gan_torch.architectures import resnet5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DCGAN = (os.path.join(REPO, "example_configs", "dcgan_polygons28.gin"),
         ["options.batch_size = 4",
          "ModularGAN.g_optimizer_fn = @tf.train.RMSPropOptimizer",
          "ModularGAN.d_optimizer_fn = @tf.train.MomentumOptimizer",
          "tf.train.RMSPropOptimizer.momentum = 0.5",
          "tf.train.MomentumOptimizer.use_nesterov = True"])
RESNET5 = (os.path.join(REPO, "example_configs",
                        "resnet_lsun-bedroom128.gin"),
           ["options.batch_size = 2"])


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    yield
    eval_utils.set_inception_fn(None)
    datasets.set_fake_dataset(False)
    tgin.clear_config()


def _argv(config, model_dir, steps, schedule="train", *extra):
    path, bindings = config
    bindings = bindings + [f"options.training_steps = {steps}",
                           "run_config.iterations_per_loop = 1",
                           "run_config.save_checkpoints_steps = 1"]
    return ([f"--model_dir={model_dir}", f"--schedule={schedule}",
             "--device=cpu", "--data_fake_dataset", f"--gin_config={path}"]
            + [f"--gin_bindings={b}" for b in bindings] + list(extra))


def _assert_resume_is_bitwise(config, tmp_path):
    """2 steps in one run; 1 + 1 in two. Returns the one-run report."""
    one_run, two_runs = tmp_path / "one", tmp_path / "two"
    report = main.main(_argv(config, one_run, 2))
    assert report.steps == [1, 2]
    assert all(np.isfinite(v) for m in report.metrics for v in m.values())
    for steps in (1, 2):
        tgin.clear_config()
        main.main(_argv(config, two_runs, steps))
    with np.load(one_run / "model.ckpt-2.npz") as a, \
            np.load(two_runs / "model.ckpt-2.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
        return report, set(a.files)


def test_dcgan_polygons_trains_resumes_and_evaluates(tmp_path):
    report, keys = _assert_resume_is_bitwise(DCGAN, tmp_path)
    assert report.state.generator.g_dc1.kernel.shape[0] == 512
    # RMSProp's accumulator and trace, the momentum's trace.
    for key in (".g_opt.nu['generator/g_dc4/kernel']",
                ".g_opt.trace['generator/g_dc4/kernel']",
                ".d_opt.trace['discriminator/d_fc4/kernel']",
                ".g_opt.count", ".d_opt.count"):
        assert key in keys, key
    assert not any(".mu[" in k for k in keys)

    run = tmp_path / "one"
    tgin.clear_config()
    eval_utils.set_inception_fn(fake_inception)
    main.main(_argv(DCGAN, run, 2, "eval_after_train", "--eval_every_steps=2",
                    "--gin_bindings=evaluation.num_accu_examples = 64"))
    with open(run / "scores.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["step"] for r in rows] == ["2"]
    assert np.isfinite(float(rows[0]["fid_score_mean"]))
    assert np.isfinite(float(rows[0]["inception_score_mean"]))

    # The export holds moving averages (no accumulator), and the JAX
    # package's loaders give what the port's give (1e-4: f32 deconvs).
    export_dir = str(run / "tfhub" / "2")
    with np.load(os.path.join(export_dir, "module.npz")) as data:
        assert any(k.endswith("/moving_mean") for k in data.files)
        assert not any("/accu/" in k for k in data.files)
    gen_t, spec = export.load_generator(export_dir, device="cpu")
    gen_j, _ = jexport.load_generator(export_dir)
    z = export.sample_z(spec, 3)
    images = th.np32(gen_t(z))
    assert images.shape == (3, 28, 28, 1)
    th.assert_close(images, gen_j(z), rtol=1e-4, atol=1e-5)
    disc_t, _ = export.load_discriminator(export_dir, device="cpu")
    disc_j, _ = jexport.load_discriminator(export_dir)
    for got, want in zip(disc_t(images), disc_j(images)):
        th.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_resnet5_wgangp_trains_and_resumes_bitwise(tmp_path, monkeypatch):
    # ch 4: resnet5's width is a constructor argument, as in JAX.
    monkeypatch.setitem(GENERATORS, "resnet5_arch",
                        functools.partial(resnet5.Generator, ch=4))
    monkeypatch.setitem(DISCRIMINATORS, "resnet5_arch",
                        functools.partial(resnet5.Discriminator, ch=4))
    report, keys = _assert_resume_is_bitwise(RESNET5, tmp_path)
    assert set(report.metrics[0]) == {f"loss/d_{i}" for i in range(5)} | {
        "loss/penalty", "loss/g"}
    assert all(m["loss/penalty"] > 0 for m in report.metrics)
    assert ".d_opt.mu['discriminator/disc_final_fc/kernel']" in keys

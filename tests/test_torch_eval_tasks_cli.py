"""The eval tasks through the port's entry point on the CPU:
`compare_gan_torch.main --schedule=eval_after_train` with all ten tasks
(the dummy architecture, unconditional with uniform z, as the G/D tasks
need) and BigGAN-deep at 64 px, ch 16, with the six tasks that read
samples and features. The two packages' evaluate_checkpoint are held to
each other in test_torch_eval_tasks_parity.py."""

import csv
import os

import numpy as np
import pytest

from tests import torch_helpers  # noqa: F401 (one torch thread)
from tests.helpers import fake_inception

from compare_gan_torch import config as tgin
from compare_gan_torch import datasets, eval_utils, main

TEN_TASKS = ("InceptionScoreTask", "FIDScoreTask", "KIDScoreTask",
             "PRDTask", "MultiscaleSSIMTask", "FractalDimensionTask",
             "GeneratorConditionNumberTask", "AccuracyTask", "GILBOTask")
GAN_METRICS = ("log_condition_number_count", "log_condition_number_mean",
               "log_condition_number_std", "train_accuracy",
               "test_accuracy", "fake_accuracy", "train_d_loss",
               "test_d_loss", "gilbo", "gilbo_train_consistency",
               "gilbo_eval_consistency", "gilbo_self_consistency")
SESSION_METRICS = ("inception_score", "fid_score", "kid_score", "prd_f8",
                   "prd_f1_8", "ms_ssim", "fractal_dimension")
DUMMY = ["dataset.name = 'cifar10'", "options.gan_class = @ModularGAN",
         "options.architecture = 'dummy_arch'", "options.batch_size = 4",
         "options.z_dim = 8", "options.disc_iters = 1"]
DEEP = ["dataset.name = 'imagenet_64'", "options.gan_class = @ModularGAN",
        "options.architecture = 'resnet_biggan_deep_arch'",
        "options.batch_size = 2", "options.z_dim = 16",
        "options.disc_iters = 2", "loss.fn = @hinge",
        "penalty.fn = @no_penalty", "weights.initializer = 'orthogonal'",
        "spectral_norm.singular_value = 'auto'",
        "standardize_batch.use_moving_averages = False",
        "ModularGAN.conditional = True", "ModularGAN.g_use_ema = True",
        "ModularGAN.experimental_joint_gen_for_disc = True",
        "ModularGAN.experimental_fake_only_g_loss = True",
        "G.batch_norm_fn = @conditional_batch_norm",
        "G.spectral_norm = True", "D.spectral_norm = True",
        "resnet_biggan_deep.Generator.ch = 16",
        "resnet_biggan_deep.Discriminator.ch = 16",
        "z.distribution_fn = @tf.random.normal"]


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    eval_utils.set_inception_fn(fake_inception)
    yield
    eval_utils.set_inception_fn(None)
    datasets.set_fake_dataset(False)
    tgin.clear_config()


def _argv(model_dir, bindings, schedule, steps, *extra):
    bindings = bindings + [f"options.training_steps = {steps}",
                           "run_config.iterations_per_loop = 1",
                           f"run_config.save_checkpoints_steps = {steps}"]
    return ([f"--model_dir={model_dir}", f"--schedule={schedule}",
             "--device=cpu", "--data_fake_dataset", "--eval_every_steps=0"]
            + [f"--gin_bindings={b}" for b in bindings] + list(extra))


def _tasks(names):
    return ("--gin_bindings=evaluation.eval_tasks = ["
            + ", ".join(f"@{n}()" for n in names) + "]")


def _row(model_dir):
    with open(os.path.join(model_dir, "scores.csv"), newline="") as f:
        (row,) = list(csv.DictReader(f))
    return row


def test_all_ten_tasks_through_the_cli(tmp_path):
    """Every metric of the ten tasks in the row, finite, at the CLI's 3
    averaging runs; the G/D tasks once per checkpoint (`_std` 0)."""
    main.main(_argv(tmp_path, DUMMY, "train", 1))
    tgin.clear_config()
    report = main.main(_argv(
        tmp_path, DUMMY, "eval_after_train", 1,
        "--gin_bindings=evaluation.num_accu_examples = 64",
        "--gin_bindings=GILBOTask.train_steps = 3",
        "--gin_bindings=GILBOTask.eval_batches = 1",
        _tasks(TEN_TASKS)))
    row = _row(tmp_path)
    for metric in SESSION_METRICS + GAN_METRICS:
        for suffix in ("mean", "std", "list"):
            assert f"{metric}_{suffix}" in row, metric
        assert np.isfinite(float(row[metric + "_mean"])), metric
    for metric in SESSION_METRICS:
        assert len(row[metric + "_list"].split("_")) == 3, metric
    for metric in GAN_METRICS:
        assert float(row[metric + "_std"]) == 0.0
    assert float(row["log_condition_number_count_mean"]) == 64
    assert set(report.evals[0]["task_seconds"]) == set(TEN_TASKS)
    assert "gan_tasks" in report.evals[0]["seconds"]


def test_biggan_deep_trains_and_evaluates_through_the_cli(tmp_path):
    """BigGAN-deep at 64 px, ch 16 (attention after G's B8): 2 steps, then
    the six tasks that read samples and features on checkpoint 2, with the
    BN accumulators filled."""
    report = main.main(_argv(tmp_path, DEEP, "train", 2))
    assert report.steps == [1, 2]
    assert all(np.isfinite(v) for m in report.metrics for v in m.values())
    assert "generator/non_local_block/sigma" in report.state.params()
    tgin.clear_config()
    main.main(_argv(tmp_path, DEEP, "eval_after_train", 2,
                    "--num_eval_averaging_runs=1",
                    "--gin_bindings=evaluation.num_accu_examples = 64",
                    _tasks(TEN_TASKS[:6])))
    row = _row(tmp_path)
    assert row["step"] == "2"
    for metric in SESSION_METRICS:
        assert np.isfinite(float(row[metric + "_mean"])), metric
    with np.load(tmp_path / "tfhub" / "2" / "model.ckpt-2.npz") as data:
        counters = [float(data[k]) for k in data.files
                    if k.endswith("accu_counter']")]
    assert counters and all(abs(c - 1) < 1e-6 for c in counters)

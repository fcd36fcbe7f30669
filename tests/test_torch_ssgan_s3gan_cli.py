"""The self-supervised GANs through the port's CLI, checkpoints and interop,
on the CPU: s3gan32_polygons_partial.gin (on a locally generated
partially-labeled polygon set) and ssgan32_polygons_oriented.gin each train
two steps through `compare_gan_torch.main` and are evaluated to one
scores.csv row; an S3GAN checkpoint holds D's heads under the JAX keys,
round-trips bitwise and resumes bitwise; checkpoints of either package load
into the other; a ModularGAN checkpoint keeps its keys."""

import csv
import os

import jax
import numpy as np
import pytest
import torch

from tests import torch_helpers as th
from tests.helpers import fake_inception

from compare_gan_tpu import checkpoint as jckpt
from compare_gan_tpu import config as jgin
from compare_gan_tpu import core as jcore
from compare_gan_tpu import datasets as jdatasets
from compare_gan_tpu import runner_lib as jrunner
from compare_gan_tpu.ops import pallas_attention
from compare_gan_torch import checkpoint as ckpt_lib
from compare_gan_torch import config as tgin
from compare_gan_torch import core, datasets, eval_utils, interop, main
from compare_gan_torch import polygons, runner_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEAD_SCOPES = ("discriminator_rotation/", "discriminator_predictor/",
               "discriminator_projection/")
# s3gan32_polygons_partial.gin cut for the CPU: BigGAN-32 at ch 8, batch
# 16 (rotated_batch_fraction 4 leaves one example per rotation), z 20.
S3GAN = (os.path.join(REPO, "example_configs",
                      "s3gan32_polygons_partial.gin"),
         ["options.batch_size = 16", "options.z_dim = 20",
          "resnet_biggan.Generator.ch = 8",
          "resnet_biggan.Discriminator.ch = 8",
          "run_config.iterations_per_loop = 1",
          "run_config.save_checkpoints_steps = 1"])
# ssgan32_polygons_oriented.gin at its published widths, batch 4 with 8
# rotated examples, on fake data.
SSGAN = (os.path.join(REPO, "example_configs",
                      "ssgan32_polygons_oriented.gin"),
         ["options.batch_size = 4", "SSGAN.rotated_batch_size = 8",
          "run_config.iterations_per_loop = 1",
          "run_config.save_checkpoints_steps = 1"])


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    pallas_attention._INTERPRET = True
    yield
    eval_utils.set_inception_fn(None)
    datasets.set_fake_dataset(False)
    jdatasets.set_fake_dataset(False)
    pallas_attention._INTERPRET = False
    tgin.clear_config()


@pytest.fixture
def partial_polygons(tmp_path, monkeypatch):
    """A small convex_polygons_partial set (20% of train labels kept, the
    rest -1) under a data dir of its own."""
    data_dir = tmp_path / "data"
    polygons.write_partial_npz_dataset(str(data_dir), n_train=96, n_test=32,
                                       n_holdout=8)
    monkeypatch.setattr(datasets, "DATA_DIR", str(data_dir))
    return data_dir


def _argv(config, model_dir, schedule="train", *extra):
    path, bindings = config
    return ([f"--model_dir={model_dir}", f"--schedule={schedule}",
             "--device=cpu", f"--gin_config={path}"]
            + [f"--gin_bindings={b}" for b in bindings] + list(extra))


def _finite(report):
    return all(np.isfinite(v) for m in report.metrics for v in m.values())


def test_s3gan_cli_trains_on_partial_labels_and_evaluates(tmp_path,
                                                          partial_polygons):
    """Two steps on the partially-labeled polygons (label_frac < 1), then
    eval_after_train of both checkpoints on fake data with a fake
    Inception: the eval reads G alone from a TrainState with heads."""
    run = tmp_path / "s3gan"
    report = main.main(_argv(S3GAN, run, "train",
                             "--gin_bindings=options.training_steps = 2"))
    assert report.steps == [1, 2] and _finite(report)
    for key in ("loss/rotation_real_loss", "loss/rotation_fake_loss",
                "loss/rotation_accuracy_real", "loss/class_loss_real"):
        assert key in report.metrics[0], key
    assert all(m["loss/label_frac"] < 1 for m in report.metrics)
    with np.load(run / "model.ckpt-2.npz") as data:
        for scope in HEAD_SCOPES:
            assert any(k.startswith(f".params['{scope}") for k in data.files)
            assert any(k.startswith(f".d_opt.mu['{scope}") for k in data.files)
    with open(run / "summaries.jsonl") as f:
        assert "loss/class_loss_real" in f.read()

    tgin.clear_config()
    eval_utils.set_inception_fn(fake_inception)
    report = main.main(_argv(
        S3GAN, run, "eval_after_train", "--data_fake_dataset",
        "--eval_every_steps=2", "--gin_bindings=options.training_steps = 2",
        "--gin_bindings=evaluation.num_accu_examples = 64"))
    with open(run / "scores.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["step"] for r in rows] == ["2"]
    assert np.isfinite(float(rows[0]["fid_score_mean"]))


def test_ssgan_cli_trains_and_evaluates(tmp_path):
    run = tmp_path / "ssgan"
    report = main.main(_argv(SSGAN, run, "train", "--data_fake_dataset",
                             "--gin_bindings=options.training_steps = 2"))
    assert report.steps == [1, 2] and _finite(report)
    assert {"loss/c_real_loss", "loss/c_fake_loss",
            "loss/rotation_accuracy"} <= set(report.metrics[0])
    tgin.clear_config()
    eval_utils.set_inception_fn(fake_inception)
    main.main(_argv(SSGAN, run, "eval_after_train", "--data_fake_dataset",
                    "--eval_every_steps=2",
                    "--gin_bindings=options.training_steps = 2",
                    "--gin_bindings=evaluation.num_accu_examples = 64"))
    with open(run / "scores.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["step"] for r in rows] == ["2"]
    assert np.isfinite(float(rows[0]["inception_score_mean"]))


def test_s3gan_resume_is_bitwise(tmp_path, partial_polygons):
    """Two steps in one run equal one step, a restart, and one more: the
    checkpoint carries the heads, their Adam moments and SN u vectors."""
    one_run, two_runs = tmp_path / "one", tmp_path / "two"
    main.main(_argv(S3GAN, one_run, "train",
                    "--gin_bindings=options.training_steps = 2"))
    for steps in (1, 2):
        tgin.clear_config()
        main.main(_argv(S3GAN, two_runs, "train",
                        f"--gin_bindings=options.training_steps = {steps}"))
    with np.load(one_run / "model.ckpt-2.npz") as a, \
            np.load(two_runs / "model.ckpt-2.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k


def _gans(config, extra=()):
    """The JAX package's and the port's GAN of one config file."""
    path, bindings = config
    bindings = list(bindings) + list(extra)
    jgin.parse_config_files_and_bindings([path], bindings)
    jgin.bind("attention.use_pallas", False)
    tgin.parse_config_files_and_bindings([path], bindings)
    joptions, toptions = jrunner.get_options_dict(), \
        runner_lib.get_options_dict()
    jgan = joptions["gan_class"](dataset=jdatasets.get_dataset(),
                                 parameters=joptions, model_dir="unused")
    tgan = toptions["gan_class"](dataset=datasets.get_dataset(),
                                 parameters=toptions, model_dir="unused",
                                 device="cpu")
    return jgan, tgan, toptions["batch_size"]


def _keys(ts_j):
    return {interop.key(group, name)
            for group, tree in zip(interop.GROUPS, (ts_j.params, ts_j.state,
                                                    ts_j.ema_params))
            for name in tree}


def test_s3gan_checkpoint_round_trip_is_bitwise_with_the_jax_keys(tmp_path):
    datasets.set_fake_dataset(True)
    jdatasets.set_fake_dataset(True)
    jgan, tgan, batch_size = _gans(S3GAN, ["dataset.name = 'cifar10'"])
    ts_j = jax.eval_shape(lambda key: jgan.init_state(key, batch_size),
                          jax.random.PRNGKey(0))
    ts = tgan.init_state(seed=3)
    ts, _ = tgan.make_train_step(batch_size)(
        ts, next(tgan.input_batches(batch_size)))
    path = ckpt_lib.save_checkpoint(str(tmp_path), ts, ts.step)
    with np.load(path) as data:
        variables = {k for k in data.files if k.startswith(
            (".params", ".state", ".ema_params"))}
    assert variables == _keys(ts_j)
    assert any(".params['discriminator_projection/kernel']" == k
               for k in variables)

    restored = ckpt_lib.restore_checkpoint(path, tgan.init_state(seed=4))
    want, got = interop.state_dict(ts), interop.state_dict(restored)
    assert set(want) == set(got)
    for k in want:
        assert torch.equal(want[k], got[k]), k
    for a, b in ((ts.g_opt, restored.g_opt), (ts.d_opt, restored.d_opt)):
        assert a.count == b.count
        for moment in ("mu", "nu"):
            assert set(getattr(a, moment)) == set(getattr(b, moment))
            for k, v in getattr(a, moment).items():
                assert torch.equal(v, getattr(b, moment)[k]), k


def test_checkpoints_of_either_package_load_into_the_other(tmp_path):
    """A JAX S3GAN checkpoint's variables load into the port, and the
    port's back into the JAX package: D and its heads then give the same
    losses on both sides (1e-4, as the train-step tests)."""
    datasets.set_fake_dataset(True)
    jdatasets.set_fake_dataset(True)
    jgan, tgan, batch_size = _gans(S3GAN, ["dataset.name = 'cifar10'"])
    ts_j = jax.jit(lambda key: jgan.init_state(key, batch_size))(
        jax.random.PRNGKey(0))
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), ts_j, 0)
    ts_t = tgan.init_state(seed=5)
    with np.load(jpath) as data:
        interop.load_state_dict(ts_t, {
            k: interop.to_port(data[k]) for k in data.files
            if k.startswith((".params", ".state", ".ema_params"))})
    for name, value in ts_j.params.items():
        assert np.array_equal(interop.to_jax(ts_t.params()[name]),
                              np.asarray(value)), name

    # The port's checkpoint, read back as JAX variables.
    ts_t.discriminator.final_fc.bias.data.fill_(0.25)  # A port-side change.
    tpath = ckpt_lib.save_checkpoint(str(tmp_path / "port"), ts_t, 0)
    with np.load(tpath) as data:  # Stored in the JAX layout already.
        assert _keys(ts_j) <= set(data.files)
        params = {n: data[interop.key("params", n)] for n in ts_j.params}
        state = {n: data[interop.key("state", n)] for n in ts_j.state}
    for name, value in params.items():
        assert value.shape == ts_j.params[name].shape, name

    rng = np.random.RandomState(0)
    features = {"images": rng.rand(batch_size, 32, 32, 3).astype(np.float32),
                "generated": rng.rand(batch_size, 32, 32, 3).astype(
                    np.float32),
                "sampled_labels": rng.randint(0, 10, batch_size).astype(
                    np.int32)}
    labels = rng.randint(-1, 10, batch_size).astype(np.int32)
    want, _ = jax.jit(lambda p, s: jcore.apply(
        lambda: jgan.create_loss(features, labels), p, s))(params, state)
    with torch.no_grad(), core.no_state_updates():
        got = tgan.create_loss({k: torch.from_numpy(v)
                                for k, v in features.items()},
                               torch.from_numpy(labels))
    for k in want:
        th.assert_close(got[k], want[k], rtol=1e-4, atol=1e-5, what=k)


def test_modular_gan_checkpoint_keeps_its_keys(tmp_path):
    """No head scope, D's Adam moments cover D alone, and the variables are
    the JAX package's init_state keys (biggan32 at ch 8)."""
    datasets.set_fake_dataset(True)
    jdatasets.set_fake_dataset(True)
    config = (os.path.join(REPO, "example_configs",
                           "biggan32_polygons_multiclass.gin"),
              ["dataset.name = 'cifar10'", "options.batch_size = 2",
               "resnet_biggan.Generator.ch = 8",
               "resnet_biggan.Discriminator.ch = 8"])
    jgan, tgan, batch_size = _gans(config)
    ts_j = jax.eval_shape(lambda key: jgan.init_state(key, batch_size),
                          jax.random.PRNGKey(0))
    ts = tgan.init_state(seed=0)
    assert not ts.heads.jax_variables()[0] and not ts.heads.jax_variables()[1]
    path = ckpt_lib.save_checkpoint(str(tmp_path), ts, 0)
    with np.load(path) as data:
        files = set(data.files)
    variables = {k for k in files
                 if k.startswith((".params", ".state", ".ema_params"))}
    assert variables == _keys(ts_j)
    g_names = {k for k in ts_j.params if k.startswith("generator/")}
    d_names = {k for k in ts_j.params if k.startswith("discriminator/")}
    assert g_names | d_names == set(ts_j.params)
    opt = {f".{o}.{m}['{n}']" for o, names in (("g_opt", g_names),
                                               ("d_opt", d_names))
           for m in ("mu", "nu") for n in names}
    assert files - variables == opt | {
        ".step", ".disc_step", ".seed", ".g_opt.count", ".d_opt.count"}

"""The port's GILBO protocol and the checks of the tasks that need G or
D, on the dummy architecture (as tests/test_gilbo_accuracy.py runs the
JAX package's): the cycle protocol's learning-rate decay, exact resume,
the regressor files named by the generator they were trained against, the
artifacts, the task's keyword precedence, and the refusals (a non-uniform
prior; a conditional model), before any eval work. Also the condition
number task's own draw from the prior."""

import os
import pickle

import numpy as np
import pytest
import torch

from tests import torch_helpers  # noqa: F401 (one torch thread)
from tests.helpers import fake_inception

from compare_gan_torch import checkpoint as ckpt_lib
from compare_gan_torch import config as tgin
from compare_gan_torch import datasets, eval_gan_lib, eval_utils, export
from compare_gan_torch.gans import modular_gan
from compare_gan_torch.metrics import accuracy, gilbo, jacobian_conditioning


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    datasets.set_fake_dataset(True)
    yield
    datasets.set_fake_dataset(False)
    tgin.clear_config()


def _dummy():
    """The dummy architecture on fake CIFAR-10, z_dim 4 (uniform prior)."""
    tgin.parse_config("")
    gan = modular_gan.ModularGAN(
        dataset=datasets.get_dataset("cifar10"), model_dir="unused",
        parameters={"architecture": "dummy_arch", "z_dim": 4, "lambda": 1,
                    "disc_iters": 1}, device="cpu")
    return gan


def test_gilbo_cycle_protocol_decays_the_rate_until_min(monkeypatch):
    """With a hopeless cycle GILBO every cycle decays the rate by half,
    and training stops once it is below gilbo_min_lr: 4 cycles of 2 steps
    (tests/test_gilbo_accuracy.py:42-77)."""
    gan = _dummy()
    ts = gan.init_state(seed=0)
    seen = []
    orig = gilbo._Gilbo.train_step

    def spy(self, index):
        seen.append(self.tx.lr)
        orig(self, index)
        return torch.tensor(10.0)

    monkeypatch.setattr(gilbo._Gilbo, "train_step", spy)
    out = gilbo.train_gilbo(gan, ts, batch_size=8, eval_batches=2,
                            learning_rate=1e-3,
                            options={"gilbo_max_train_cycles": 50,
                                     "gilbo_train_steps_per_cycle": 2,
                                     "gilbo_min_lr": 1e-4})
    assert np.isfinite(out[0])
    assert sorted({round(x, 10) for x in seen}, reverse=True) == \
        [1e-3, 5e-4, 2.5e-4, 1.25e-4]
    assert len(seen) == 8


def test_gilbo_resumes_exactly_and_per_generator(tmp_path, monkeypatch):
    """An interrupted cycle run resumes to the unbroken run's result
    (tests/test_gilbo_accuracy.py:300-370). The files carry the
    generator's fingerprint: generator A's higher-numbered files in a
    shared outdir neither serve B nor stop B's own resume, which trains
    only the cycle it lacks."""
    # One TrainState per GAN: a GAN's init_state fills its one G in place.
    gan_a, gan = _dummy(), _dummy()
    ts_a, ts_b = gan_a.init_state(seed=0), gan.init_state(seed=1)
    opts = {"gilbo_max_train_cycles": 2, "gilbo_train_steps_per_cycle": 2}
    kw = dict(batch_size=8, eval_batches=1)
    full_b = gilbo.train_gilbo(gan, ts_b, options=opts,
                               outdir=str(tmp_path / "full"), **kw)

    shared = tmp_path / "shared"
    gilbo.train_gilbo(gan_a, ts_a, options={**opts,
                                          "gilbo_max_train_cycles": 3},
                      outdir=str(shared), **kw)
    gilbo.train_gilbo(gan, ts_b, options={**opts,
                                          "gilbo_max_train_cycles": 1},
                      outdir=str(shared), **kw)
    files = sorted(os.listdir(shared))
    fps = {f.split("-")[1] for f in files if f.startswith("gilbo_model-")}
    assert len(fps) == 2
    steps = []
    orig = gilbo._Gilbo.train_step
    monkeypatch.setattr(gilbo._Gilbo, "train_step",
                        lambda self, i: steps.append(i) or orig(self, i))
    resumed = gilbo.train_gilbo(gan, ts_b, options=opts, outdir=str(shared),
                                **kw)
    assert steps == [2, 3]  # Cycle 2 only: cycle 1 was resumed.
    np.testing.assert_array_equal(np.asarray(resumed), np.asarray(full_b))
    steps.clear()
    again = gilbo.train_gilbo(gan, ts_b, options=opts, outdir=str(shared),
                              **kw)
    assert steps == []
    np.testing.assert_array_equal(np.asarray(again), np.asarray(full_b))


def test_gilbo_fixed_steps_resume_and_artifacts(tmp_path):
    """The fixed-steps path saves once; a rerun trains nothing and gives
    the same result. With images, the reference's artifacts are written:
    eval_dists.p, the consistency pickles (skl = (kl + rkl) / 2 >= 0) and
    the PNG strips."""
    gan = _dummy()
    ts = gan.init_state(seed=0)
    train_images = gan.dataset.load_eval_images(16) / 255.0
    kw = dict(batch_size=8, train_steps=4, eval_batches=2,
              train_images=train_images, outdir=str(tmp_path))
    first = gilbo.train_gilbo(gan, ts, **kw)
    (ckpt,) = [f for f in os.listdir(tmp_path)
               if f.startswith("gilbo_model-")]
    assert ckpt.endswith("-00000.p")
    mtime = (tmp_path / ckpt).stat().st_mtime_ns
    np.testing.assert_array_equal(gilbo.train_gilbo(gan, ts, **kw), first)
    assert (tmp_path / ckpt).stat().st_mtime_ns == mtime
    assert np.isfinite(first[1]) and first[3] >= 0.0
    with open(tmp_path / "eval_dists.p", "rb") as f:
        dists = pickle.load(f)
    assert dists["dist_p1"].shape == (16, 4)
    assert dists["images"].shape == (16, 32, 32, 3)
    for mode in ("train", "self"):
        with open(tmp_path / f"{mode}_consistency_dists.p", "rb") as f:
            c = pickle.load(f)
        assert (c["consistency_skl"] >= 0).all()
        np.testing.assert_allclose(
            c["consistency_skl"],
            (c["consistency_kl"] + c["consistency_rkl"]) / 2.0)
        png = tmp_path / f"consistency_image_{mode}_000000_000007.png"
        assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_gilbo_task_kwargs_win_and_a_normal_prior_is_refused(monkeypatch):
    gan = _dummy()
    ts = gan.init_state(seed=0)
    seen = {}
    orig = gilbo.train_gilbo

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return orig(*args, **kwargs)

    monkeypatch.setattr(gilbo, "train_gilbo", spy)
    task = gilbo.GILBOTask(batch_size=4, train_steps=2, eval_batches=1)
    out = task.run_with_gan(gan, ts, batch_size=16)
    assert seen["batch_size"] == 4 and np.isfinite(out["gilbo"])
    assert set(out) == task.metric_list()
    tgin.parse_config("z.distribution_fn = @tf.random.normal")
    with pytest.raises(ValueError, match="U\\(-1, 1\\)"):
        task.run_with_gan(gan, ts)


@pytest.mark.parametrize("cfg,task,match", [
    ("z.distribution_fn = @tf.random.normal", "gilbo", "U\\(-1, 1\\)"),
    ("", "accuracy_on_conditional", "only support unconditional"),
])
def test_eval_refuses_before_any_work(tmp_path, monkeypatch, cfg, task,
                                      match):
    """A GILBO under a normal prior, and any G/D task on a conditional
    model, fail before the fill, the sampling and Inception."""
    tgin.parse_config(cfg)
    conditional = task == "accuracy_on_conditional"
    gan = modular_gan.ModularGAN(
        dataset=datasets.get_dataset("cifar10"), model_dir=str(tmp_path),
        parameters={"architecture": "dummy_arch", "z_dim": 4, "lambda": 1,
                    "disc_iters": 1}, device="cpu", conditional=conditional)
    ts = gan.init_state(seed=0)
    path = ckpt_lib.save_checkpoint(str(tmp_path), ts, 1)

    def too_late(*args, **kwargs):
        raise AssertionError("eval work started before the task checks")

    monkeypatch.setattr(eval_gan_lib, "_update_bn_accumulators", too_late)
    tasks = [gilbo.GILBOTask(train_steps=2, eval_batches=1)
             if task == "gilbo" else accuracy.AccuracyTask()]
    with pytest.raises(ValueError, match=match):
        eval_gan_lib.evaluate_checkpoint(gan, path, tasks, batch_size=8)


def test_condition_number_task_samples_the_prior():
    """run_with_gan draws a batch from the GAN's prior and reports the
    three statistics (tests/test_metrics.py:218-230)."""
    gan = _dummy()
    ts = gan.init_state(seed=0)
    task = jacobian_conditioning.GeneratorConditionNumberTask()
    out = task.run_with_gan(gan, ts, batch_size=4)
    assert set(out) == task.metric_list()
    assert out["log_condition_number_count"] == 4
    assert np.isfinite(out["log_condition_number_mean"])


def test_the_g_d_tasks_evaluate_a_module_export(tmp_path):
    """evaluate_tfhub_module gives the tasks the export's G, D (built on
    first use) and training prior: the same values as the checkpoint's
    eval of the same weights."""
    gan = _dummy()
    ts = gan.init_state(seed=0)
    export.export_module(gan, ts, str(tmp_path / "export"))
    path = ckpt_lib.save_checkpoint(str(tmp_path), ts, 1)

    def tasks():
        return [jacobian_conditioning.GeneratorConditionNumberTask(),
                accuracy.AccuracyTask(),
                gilbo.GILBOTask(train_steps=2, eval_batches=1)]

    eval_utils.set_inception_fn(fake_inception)
    try:
        got = eval_gan_lib.evaluate_tfhub_module(
            str(tmp_path / "export"), tasks(), batch_size=16, device="cpu")
        want = eval_gan_lib.evaluate_checkpoint(gan, path, tasks(),
                                                batch_size=16)
    finally:
        eval_utils.set_inception_fn(None)
    assert set(got) == set(want)
    assert len(got) == 3 * 12
    for key, value in want.items():
        if key.endswith("_mean"):
            np.testing.assert_allclose(got[key], value, rtol=1e-6,
                                       atol=1e-6, err_msg=key)

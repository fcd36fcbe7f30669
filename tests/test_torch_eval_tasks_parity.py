"""The port's evaluate_checkpoint against the JAX package's on the same
weights (the dummy architecture, the port's initial values carried by
interop.py) and the same z (the JAX package's eval draws handed to the
port), at one averaging run; and at two, where the JAX package frees the
images MS-SSIM and the fractal dimension read and fails, while the port
keeps them because such a task is listed."""

import jax
import numpy as np
import pytest

from tests import torch_helpers as th
from tests.helpers import fake_inception

from compare_gan_tpu import checkpoint as jckpt
from compare_gan_tpu import config as jgin
from compare_gan_tpu import datasets as jdatasets
from compare_gan_tpu import eval_gan_lib as jeval
from compare_gan_tpu import eval_utils as jeval_utils
from compare_gan_tpu.gans import modular_gan as jmodular
from compare_gan_tpu.metrics import fractal_dimension as jfractal
from compare_gan_tpu.metrics import inception_score as jinception_score
from compare_gan_tpu.metrics import kid_score as jkid
from compare_gan_tpu.metrics import ms_ssim_score as jms_ssim
from compare_gan_tpu.ops import rng as jrng
from compare_gan_torch import checkpoint as ckpt_lib
from compare_gan_torch import config as tgin
from compare_gan_torch import datasets, eval_gan_lib, eval_utils
from compare_gan_torch.gans import modular_gan
from compare_gan_torch.metrics import (fractal_dimension, inception_score,
                                       kid_score, ms_ssim_score)


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    jgin.clear_config()
    eval_utils.set_inception_fn(fake_inception)
    jeval_utils.set_inception_fn(fake_inception)
    yield
    eval_utils.set_inception_fn(None)
    jeval_utils.set_inception_fn(None)
    for module in (datasets, jdatasets):
        module.set_fake_dataset(False)
    jgin.clear_config()
    tgin.clear_config()


BATCH = 16


@pytest.fixture
def checkpoints(tmp_path):
    """(jgan, tgan, JAX checkpoint, port checkpoint, draw) of the dummy
    architecture on the port's weights; `draw` hands the port the JAX
    package's eval z."""
    for module in (datasets, jdatasets):
        module.set_fake_dataset(True)
    parameters = {"architecture": "dummy_arch", "z_dim": 8, "lambda": 1,
                  "disc_iters": 1}
    jgan = jmodular.ModularGAN(dataset=jdatasets.get_dataset("cifar10"),
                               parameters=parameters,
                               model_dir=str(tmp_path / "jax"))
    tgan = modular_gan.ModularGAN(dataset=datasets.get_dataset("cifar10"),
                                  parameters=parameters,
                                  model_dir=str(tmp_path / "port"),
                                  device="cpu")
    ts_t = tgan.init_state(seed=3)
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"),
                                  th.jax_train_state(jgan, ts_t), 1)
    tpath = ckpt_lib.save_checkpoint(str(tmp_path / "port"), ts_t, 1)

    def draw(stream, i):
        run = int(stream[len("run"):])
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(42), run), i)
        with jrng.rng_context(key):
            return np.asarray(jeval.z_generator([BATCH, 8], name="z")), None

    return jgan, tgan, jpath, tpath, draw


def test_evaluate_checkpoint_equals_the_jax_package_at_one_run(checkpoints):
    """The same images (the JAX package's z through the same weights), so
    MS-SSIM within 1e-5, the fractal dimension and KID within 1e-6 (f64
    metrics of f32 images from two backends) and IS within 1e-9."""
    jgan, tgan, jpath, tpath, draw = checkpoints
    j_tasks = [jinception_score.InceptionScoreTask(), jkid.KIDScoreTask(),
               jms_ssim.MultiscaleSSIMTask(),
               jfractal.FractalDimensionTask()]
    t_tasks = [inception_score.InceptionScoreTask(), kid_score.KIDScoreTask(),
               ms_ssim_score.MultiscaleSSIMTask(),
               fractal_dimension.FractalDimensionTask()]
    want = jeval.evaluate_checkpoint(jgan, jpath, j_tasks,
                                     batch_size=BATCH,
                                     export_accu_checkpoint=False)
    got = eval_gan_lib.evaluate_checkpoint(tgan, tpath, t_tasks,
                                           batch_size=BATCH, draw=draw)
    assert set(got) == set(want)
    for key, tol in (("inception_score_mean", 1e-9), ("kid_score_mean", 1e-6),
                     ("ms_ssim_mean", 1e-5),
                     ("fractal_dimension_mean", 1e-6)):
        np.testing.assert_allclose(got[key], want[key], rtol=tol, err_msg=key)


def test_two_averaging_runs_fail_in_the_jax_package_not_in_the_port(
        checkpoints):
    """The JAX package frees run 1's images before its tasks run, so
    MS-SSIM draws from no images and the fractal dimension fails its
    assertion; the port keeps them and scores both runs."""
    jgan, tgan, jpath, tpath, draw = checkpoints
    with pytest.raises(ValueError, match="high <= 0"):
        jeval.evaluate_checkpoint(jgan, jpath, [jms_ssim.MultiscaleSSIMTask()],
                                  batch_size=BATCH, num_averaging_runs=2,
                                  export_accu_checkpoint=False)
    with pytest.raises(AssertionError):
        jeval.evaluate_checkpoint(jgan, jpath,
                                  [jfractal.FractalDimensionTask()],
                                  batch_size=BATCH, num_averaging_runs=2,
                                  export_accu_checkpoint=False)
    got = eval_gan_lib.evaluate_checkpoint(
        tgan, tpath, [ms_ssim_score.MultiscaleSSIMTask(),
                      fractal_dimension.FractalDimensionTask()],
        batch_size=BATCH, num_averaging_runs=2, draw=draw)
    for key in ("ms_ssim", "fractal_dimension"):
        values = [float(v) for v in got[key + "_list"].split("_")]
        assert len(values) == 2 and np.isfinite(values).all(), key

"""S3GAN's option matrix against the JAX package, f32 on the CPU: one train
step (disc_iters 1) of BigGAN-32 with a small `ch` for each combination of
project_y x use_predictor x use_soft_pred and self_supervision in {none,
rotation}, on batches with unlabeled rows (hard labels of -1), and with
soft labels that have all-zero rows (use_soft_labels). Set-up and
tolerances as in tests/test_torch_ssgan_s3gan.py."""

import pytest

from compare_gan_tpu.gans import s3gan as js3gan
from compare_gan_tpu.ops import pallas_attention
from compare_gan_tpu import datasets as jdatasets
from compare_gan_torch import config as tgin
from compare_gan_torch import datasets
from compare_gan_torch.gans import s3gan
from tests.test_torch_ssgan_s3gan import (S3GAN_CFG, _config, _gans,
                                          _run_steps, _start)

HEADS = [  # (project_y, use_predictor, use_soft_pred)
    (False, False, False), (True, False, False), (True, True, False),
    (True, True, True)]


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    pallas_attention._INTERPRET = True
    jdatasets.set_fake_dataset(True)
    datasets.set_fake_dataset(True)
    yield
    datasets.set_fake_dataset(False)
    jdatasets.set_fake_dataset(False)
    pallas_attention._INTERPRET = False
    tgin.clear_config()


def _one_step(labels="hard", **options):
    cfg = S3GAN_CFG
    if not options["project_y"] and options["self_supervision"] == "none":
        # No per-row term beside the GAN loss: as for the unconditional
        # SSGAN (tests/test_torch_ssgan_s3gan.py), the hinge loss leaves D's
        # last conv bias an exactly cancelling gradient.
        cfg += "loss.fn = @non_saturating\n"
    _config(cfg, "S3GAN", {})
    jgan, tgan = _gans(js3gan.S3GAN, s3gan.S3GAN, "resnet_biggan_arch",
                       disc_iters=1, z_dim=16, rotated_batch_fraction=2,
                       **options)
    # The JAX init_state traces create_loss on int labels, which
    # use_soft_labels refuses; the variables do not depend on that option.
    jinit = None
    if options.get("use_soft_labels"):
        jinit, _ = _gans(js3gan.S3GAN, s3gan.S3GAN, "resnet_biggan_arch",
                         disc_iters=1, z_dim=16, rotated_batch_fraction=2,
                         **dict(options, use_soft_labels=False))
    ts_j, ts_t = _start(jgan, tgan, 8, jinit=jinit)
    return _run_steps(jgan, tgan, ts_j, ts_t, 8, steps=1, labels=labels)


@pytest.mark.parametrize("self_supervision", ["none", "rotation"])
@pytest.mark.parametrize("project_y,use_predictor,use_soft_pred", HEADS)
def test_head_matrix_step_matches_jax(project_y, use_predictor,
                                      use_soft_pred, self_supervision):
    """Every third row unlabeled (-1): the predictor imputes their labels
    for the projection, and the class loss reads the labeled rows only."""
    _, metrics_t = _one_step(
        labels="partial", project_y=project_y, use_predictor=use_predictor,
        use_soft_pred=use_soft_pred, self_supervision=self_supervision)
    if use_predictor:
        # The G sub-step's 8 real rows: rows 9, 12, 15 of the batch.
        assert abs(metrics_t["loss/label_frac"] - 5 / 8) < 1e-6


def test_soft_labels_step_matches_jax():
    """use_soft_labels: the class loss reads the soft rows, and all-zero
    rows count as unlabeled."""
    _, metrics_t = _one_step(
        labels="soft", use_soft_labels=True, project_y=True,
        use_predictor=True, use_soft_pred=True, self_supervision="rotation")
    assert abs(metrics_t["loss/label_frac"] - 5 / 8) < 1e-6

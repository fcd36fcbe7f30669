"""Every shipped example config builds in the port, and every binding it
makes is consumed (the port's counterpart of
tests/test_example_configs.py:77-113): after `init_state`, one train step
(the losses, penalties and z draws read their bindings when they run, not
when the GAN is built), `main._get_run_config`, the eval z and
`runner_lib._resolved_eval_settings`, each binding appears in the port's
operative config. The port's CLI parses flags with argparse, so absl's
global FLAGS play no part here."""

import functools
import glob
import os

import numpy as np
import pytest

from tests import torch_helpers  # noqa: F401 (one torch thread)

from compare_gan_torch import config as tgin
from compare_gan_torch import datasets, eval_gan_lib, main, runner_lib
from compare_gan_torch.architectures import DISCRIMINATORS, GENERATORS
from compare_gan_torch.architectures import resnet5
from compare_gan_torch.ops import rng

CONFIGS = sorted(glob.glob(os.path.join(
    os.path.dirname(__file__), "..", "example_configs", "*.gin")))
BATCH = 2
# Bindings that make each config's step cheap on the CPU at batch 2; they
# are themselves consumed when the architecture is built, so they cannot
# mask an unconsumed binding of the config.
SHRINK = {
    "biggan_imagenet128.gin": ["resnet_biggan.Generator.ch = 16",
                               "resnet_biggan.Discriminator.ch = 16"],
    "biggan128_polygons_multiclass.gin": [
        "resnet_biggan.Generator.ch = 16",
        "resnet_biggan.Discriminator.ch = 16"],
    # Batch 2 holds 2 rotated examples a rotation at most.
    "ssgan32_polygons_oriented.gin": ["SSGAN.rotated_batch_size = 8"],
    # Batch 2 leaves no rotated example at the recipes' fraction; the
    # S3GAN.* bindings are consumed when the GAN is built.
    "s3gan32_polygons_partial.gin": ['S3GAN.self_supervision = "none"'],
    "s3gan32_polygons_partial_oriented.gin": [
        'S3GAN.self_supervision = "none"'],
}


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    datasets.set_fake_dataset(True)
    yield
    datasets.set_fake_dataset(False)
    tgin.clear_config()


def test_every_example_config_is_audited():
    assert len(CONFIGS) == 11


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_every_binding_is_consumed(path, monkeypatch):
    # ResNet5's width is a constructor argument, not a binding (as in the
    # JAX package): a narrow one keeps its five WGAN-GP sub-steps cheap.
    for registry, module in ((GENERATORS, resnet5.Generator),
                             (DISCRIMINATORS, resnet5.Discriminator)):
        monkeypatch.setitem(registry, "resnet5_arch",
                            functools.partial(module, ch=4))
    tgin.parse_config_files_and_bindings(
        [path], SHRINK.get(os.path.basename(path), []))
    options = runner_lib.get_options_dict()
    gan = options["gan_class"](dataset=datasets.get_dataset(),
                               parameters=options, model_dir="unused",
                               device="cpu")
    ts = gan.init_state(seed=0)
    batch = next(gan.input_batches(BATCH))
    ts, metrics = gan.make_train_step(BATCH)(ts, batch)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    main._get_run_config("unused", "cpu")
    eval_gan_lib.z_generator((2, 4), rng.stream(0, 0, 0, "eval", "cpu"))
    runner_lib._resolved_eval_settings()

    bound = {f"{s}.{p}" for s, ps in tgin._BINDINGS.items() for p in ps}
    consumed = {f"{s}.{p}" for s, ps in tgin._OPERATIVE.items() for p in ps}
    assert bound <= consumed, sorted(bound - consumed)

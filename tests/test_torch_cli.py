"""The port's CLI, checkpoints and import hygiene: `compare_gan_torch.main`
trains a tiny BigGAN on the CPU and writes its checkpoints and TRAIN_DONE;
a checkpoint round trip is bitwise; importing the port loads no jax."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import torch_helpers  # noqa: F401 (one torch thread)

from compare_gan_torch import checkpoint as ckpt_lib
from compare_gan_torch import config as tgin
from compare_gan_torch import datasets, interop, main
from compare_gan_torch.gans import modular_gan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A 32 px BigGAN at ch=4 with the main path's trainer options.
BINDINGS = [
    "dataset.name = 'cifar10'",
    "options.gan_class = @ModularGAN",
    "options.architecture = 'resnet_biggan_arch'",
    "options.batch_size = 2",
    "options.training_steps = 2",
    "options.disc_iters = 2",
    "options.z_dim = 16",
    "loss.fn = @hinge",
    "penalty.fn = @no_penalty",
    "weights.initializer = 'orthogonal'",
    "spectral_norm.singular_value = 'auto'",
    "standardize_batch.use_moving_averages = False",
    "ModularGAN.conditional = True",
    "ModularGAN.g_use_ema = True",
    "ModularGAN.experimental_joint_gen_for_disc = True",
    "ModularGAN.experimental_fake_only_g_loss = True",
    "G.batch_norm_fn = @conditional_batch_norm",
    "G.spectral_norm = True",
    "D.spectral_norm = True",
    "resnet_biggan.Generator.ch = 4",
    "resnet_biggan.Generator.blocks_with_attention = 'B2'",
    "resnet_biggan.Discriminator.ch = 4",
    "z.distribution_fn = @tf.random.normal",
    "run_config.iterations_per_loop = 1",
    "run_config.save_checkpoints_steps = 1",
]


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    yield
    datasets.set_fake_dataset(False)
    tgin.clear_config()


def _argv(model_dir, *extra):
    return ([f"--model_dir={model_dir}", "--schedule=train", "--device=cpu",
             "--data_fake_dataset"]
            + [f"--gin_bindings={b}" for b in BINDINGS] + list(extra))


def test_cli_trains_and_checkpoints(tmp_path):
    report = main.main(_argv(tmp_path))
    for name in ("model.ckpt-0.npz", "model.ckpt-1.npz", "model.ckpt-2.npz",
                 "checkpoint", "TRAIN_DONE", "operative_config-0.gin"):
        assert (tmp_path / name).exists(), name
    assert report.steps == [1, 2]
    assert report.state.step == 2 and report.state.disc_step == 4
    assert all(np.isfinite(v) for m in report.metrics for v in m.values())
    assert set(report.metrics[0]) == {"loss/d_0", "loss/d_1",
                                      "loss/penalty", "loss/g"}
    with np.load(tmp_path / "model.ckpt-2.npz") as data:
        assert int(data[".step"]) == 2
        # Conv kernels are stored HWIO, as in the JAX package's checkpoints.
        assert data[".params['generator/final_conv/kernel']"].shape == (
            3, 3, 16, 3)
    # A second run on a trained model_dir returns without training.
    tgin.clear_config()
    again = main.main(_argv(tmp_path))
    assert again.state is None and again.steps == []


def test_cli_refuses_a_missing_gpu_and_unported_schedules(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main.main(_argv(tmp_path, "--device=cuda"))
    tgin.clear_config()
    with pytest.raises(NotImplementedError, match="eval_after_train"):
        main.main(_argv(tmp_path, "--schedule=eval_after_train"))


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    datasets.set_fake_dataset(True)
    tgin.parse_config("\n".join(BINDINGS))
    params = {"architecture": "resnet_biggan_arch", "z_dim": 16,
              "lambda": 1, "disc_iters": 2}

    def gan():
        return modular_gan.ModularGAN(
            dataset=datasets.get_dataset("cifar10"), parameters=params,
            model_dir=str(tmp_path))

    src = gan()
    ts = src.init_state(seed=3)
    batch = next(src.input_batches(2))
    ts, _ = src.make_train_step(2)(ts, batch)  # Non-zero moments and u.
    path = ckpt_lib.save_checkpoint(str(tmp_path), ts, ts.step)
    assert ckpt_lib.latest_checkpoint(str(tmp_path)) == path

    restored = ckpt_lib.restore_checkpoint(path, gan().init_state(seed=4))
    want, got = interop.state_dict(ts), interop.state_dict(restored)
    assert set(want) == set(got)
    for k in want:
        assert torch.equal(want[k], got[k]), k
    # One G update and two D sub-step updates per step.
    for a, b, count in ((ts.g_opt, restored.g_opt, 1),
                        (ts.d_opt, restored.d_opt, 2)):
        assert a.count == b.count == count
        for moment in ("mu", "nu"):
            for k, v in getattr(a, moment).items():
                assert torch.equal(v, getattr(b, moment)[k]), k
    assert (restored.step, restored.disc_step, restored.seed) == (1, 2, 3)


def test_checkpoint_retention(tmp_path):
    arrays = {".step": np.int32(0)}
    for step in range(4):
        ckpt_lib.write_arrays(str(tmp_path), arrays, step,
                              keep_checkpoint_max=2)
    names = [os.path.basename(p)
             for p in ckpt_lib.all_checkpoints(str(tmp_path))]
    assert names == ["model.ckpt-2.npz", "model.ckpt-3.npz"]
    assert not (tmp_path / "model.ckpt-0.npz").exists()


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import compare_gan_torch, compare_gan_torch.main\n"
            "import compare_gan_torch.ops.fused_attention\n"
            "import compare_gan_torch.architectures, compare_gan_torch.interop\n"
            "import compare_gan_torch.checkpoint\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'jaxlib' not in sys.modules and 'optax' not in sys.modules\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_resume_is_bitwise(tmp_path):
    """Two steps in one run equal one step, a restart, and one more: the
    draws are keyed by (seed, step, sub-step), the input stream is
    fast-forwarded and the checkpoint carries Adam, EMA and SN state."""
    one_run, two_runs = tmp_path / "one", tmp_path / "two"
    main.main(_argv(one_run))
    for steps in (1, 2):
        tgin.clear_config()
        main.main(_argv(two_runs,
                        f"--gin_bindings=options.training_steps = {steps}"))
    with np.load(one_run / "model.ckpt-2.npz") as a, \
            np.load(two_runs / "model.ckpt-2.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k

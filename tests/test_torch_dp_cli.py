"""Data parallelism through the port's CLI on the CPU, as
tests/test_multihost_launch.py:194-241 drives the JAX binary: two
`--multihost` processes with an explicit coordinator, and
`--num_devices=2` launches of two spawned gloo workers, each training
`dummy` for 4 steps. Only rank 0 writes: checkpoints 0, 2 and 4,
TRAIN_DONE, the operative config and the summaries. A run resumed from
checkpoint 2 ends where an unbroken run does. Also, in this process:
`--num_devices` beyond the CUDA devices raises, `run_config.profile`
writes a trace, and `G.batch_norm_fn = @evonorm_s0` trains."""

import os
import subprocess
import sys

import numpy as np
import pytest

from tests import torch_helpers  # noqa: F401 (one torch thread)

from compare_gan_torch import config as tgin
from compare_gan_torch import datasets, main
from compare_gan_torch.parallel import mesh_utils

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUMMY = ["--device=cpu", "--data_fake_dataset",
         "--gin_bindings=dataset.name = 'cifar10'",
         "--gin_bindings=options.architecture = 'dummy_arch'",
         "--gin_bindings=options.batch_size = 8",
         "--gin_bindings=options.gan_class = @ModularGAN",
         "--gin_bindings=options.z_dim = 16",
         "--gin_bindings=run_config.iterations_per_loop = 2",
         "--gin_bindings=run_config.save_checkpoints_steps = 2"]


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    yield
    datasets.set_fake_dataset(False)
    tgin.clear_config()


def _start(tmp_path, tag, model_dir, steps, *flags):
    """A CLI process training `dummy` to `steps`, its output in a file."""
    log = open(tmp_path / f"{tag}.log", "w")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    argv = [sys.executable, "-m", "compare_gan_torch.main",
            f"--model_dir={model_dir}",
            f"--gin_bindings=options.training_steps = {steps}"]
    proc = subprocess.Popen(argv + DUMMY + list(flags), cwd=REPO, env=env,
                            stdout=log, stderr=subprocess.STDOUT)
    return tag, proc, log


def _wait(tmp_path, runs):
    """Wait for every process; returns {tag: output}. Each must exit 0."""
    try:
        for _, proc, _ in runs:
            proc.wait(timeout=120)
    finally:
        for _, proc, log in runs:
            if proc.poll() is None:
                proc.kill()
            log.close()
    outs = {tag: (tmp_path / f"{tag}.log").read_text() for tag, _, _ in runs}
    for tag, proc, _ in runs:
        assert proc.returncode == 0, f"{tag}:\n{outs[tag][-4000:]}"
    return outs


def _checkpoint(model_dir, step):
    with np.load(model_dir / f"model.ckpt-{step}.npz") as d:
        return {k: d[k] for k in d.files}


def test_two_process_launches_write_on_rank_0_and_resume(tmp_path):
    chief, other = tmp_path / "multihost", tmp_path / "multihost_rank1"
    unbroken, resumed = tmp_path / "unbroken", tmp_path / "resumed"
    port = mesh_utils.free_port()
    # Rank 1 gets a model_dir of its own: it must write nothing there.
    multihost = [_start(tmp_path, f"host{i}", model_dir, 4, "--multihost",
                        f"--coordinator_address=127.0.0.1:{port}",
                        "--num_processes=2", f"--process_id={i}")
                 for i, model_dir in enumerate((chief, other))]
    outs = _wait(tmp_path, multihost + [
        _start(tmp_path, "unbroken", unbroken, 4, "--num_devices=2"),
        _start(tmp_path, "resumed_a", resumed, 2, "--num_devices=2")])
    outs.update(_wait(tmp_path, [
        _start(tmp_path, "resumed_b", resumed, 4, "--num_devices=2")]))

    assert "rank 0 of 2" in outs["host0"] and "rank 1 of 2" in outs["host1"]
    assert "rank 1 of 2 on cpu (host 0 of 1)" in outs["unbroken"]
    for out in outs.values():
        assert "Image summary" not in out  # Rank 0 samples without a group.
    assert not other.exists() or not os.listdir(other)
    for model_dir in (chief, unbroken, resumed):
        names = set(os.listdir(model_dir))
        assert {"TRAIN_DONE", "checkpoint", "model.ckpt-0.npz",
                "model.ckpt-2.npz", "model.ckpt-4.npz",
                "operative_config-0.gin", "summaries.jsonl"} <= names, names
        ckpt = _checkpoint(model_dir, 4)
        assert int(ckpt[".step"]) == 4
        for k, v in ckpt.items():
            assert np.isfinite(v).all(), k
    # The resumed run wrote its second operative config at step 2.
    assert "operative_config-2.gin" in os.listdir(resumed)
    # Resumed = unbroken: the draws are keyed by (seed, step, sub-step),
    # the input stream fast-forwards and the checkpoint carries the
    # optimizers' state; the two workers' sums run in a fixed order on
    # the CPU, so the checkpoints agree bitwise.
    want, got = _checkpoint(unbroken, 4), _checkpoint(resumed, 4)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_more_devices_than_exist_raise():
    with pytest.raises(ValueError, match="only 0 devices are available"):
        main.main(["--model_dir=unused", "--device=cuda",
                   "--num_devices=2"] + DUMMY[1:])


def test_profile_traces_the_second_loop(tmp_path):
    main.main([f"--model_dir={tmp_path}",
               "--gin_bindings=options.training_steps = 4",
               "--gin_bindings=run_config.profile = True"] + DUMMY)
    assert os.listdir(tmp_path / "profile") == ["trace-4.json"]


def test_evonorm_s0_trains_through_the_cli(tmp_path):
    report = main.main([
        f"--model_dir={tmp_path}", "--device=cpu", "--data_fake_dataset",
        f"--gin_config={REPO}/example_configs/resnet_cifar10.gin",
        "--gin_bindings=G.batch_norm_fn = @evonorm_s0",
        "--gin_bindings=options.batch_size = 4",
        "--gin_bindings=options.disc_iters = 1",
        "--gin_bindings=options.training_steps = 2",
        "--gin_bindings=run_config.iterations_per_loop = 1"])
    assert report.steps == [1, 2]
    assert all(np.isfinite(v) for m in report.metrics for v in m.values())
    ckpt = _checkpoint(tmp_path, 2)
    assert ".params['generator/B1/bn1/v']" in ckpt

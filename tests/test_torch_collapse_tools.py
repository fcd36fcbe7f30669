"""The tools that settle BigGAN-128's early D-loss collapse, on the CPU at
a small size: the port's init beside the JAX package's
(`tools/torch_jax_lockstep.py --mode init`), both packages in lockstep
from one init on the same batches and draws (`--mode lockstep`, with a
control that must part), the card sweep's driver
(`tools/torch_d_collapse_sweep.py`) dry-run on the CPU, and the
trajectory phase's arithmetic in chip_smoke.py."""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import torch_helpers as th

from compare_gan_tpu import datasets as jdatasets
from compare_gan_torch import config as tgin
from compare_gan_torch import datasets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
from tools import torch_jax_lockstep  # noqa: E402

CONFIG32 = os.path.join(REPO, "example_configs",
                        "biggan32_polygons_multiclass.gin")
# BigGAN-32 as published at ch 4 and batch 2, on a 64-image polygon set.
SMALL = ["--gin_config", CONFIG32, "--ch", "4", "--batch", "2",
         "--n_train", "64", "--polygon_workers", "1", "--threads", "1"]


@pytest.fixture(autouse=True)
def _restore(monkeypatch):
    # The tool points both packages' data directories at its work dir.
    monkeypatch.setattr(datasets, "DATA_DIR", datasets.DATA_DIR)
    monkeypatch.setattr(jdatasets, "DATA_DIR", jdatasets.DATA_DIR)
    yield
    tgin.clear_config()


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_lockstep_agrees_at_step_one_and_its_control_parts(tmp_path):
    """3 steps from JAX's init on the same polygon batches and JAX's
    draws: the losses agree at step 1 to 1e-4 and do not part by 1e-3
    in 3 steps; a control port with D's learning rate doubled parts at
    step 1 (its D sub-step 0 loss is the same, its sub-step 1 loss is
    not)."""
    out = tmp_path / "out"
    summary = torch_jax_lockstep.main([
        "--mode", "lockstep", *SMALL, "--steps", "3", "--seeds", "0",
        "--control_gin_bindings", "ModularGAN.d_lr = 0.001",
        "--workdir", str(tmp_path), "--out_dir", str(out)])
    assert summary["steps"] == 3
    assert summary["port_first_parting"] is None
    assert summary["control_first_parting"] == 1
    rows = _rows(out / "lockstep.csv")
    assert [int(r["step"]) for r in rows] == [1, 2, 3]
    for loss in ("d_0", "d_1", "g"):
        th.assert_close(float(rows[0][f"port_{loss}"]),
                        float(rows[0][f"jax_{loss}"]), rtol=1e-4, atol=1e-6,
                        what=loss)
    assert float(rows[0]["control_d_0"]) == float(rows[0]["port_d_0"])
    assert float(rows[0]["control_max_rel_gap"]) > 1e-3
    with open(out / "lockstep.json") as f:
        assert json.load(f) == summary


def test_init_comparison_at_a_narrow_width(tmp_path):
    """The port's own init against JAX's over three seeds at ch 4: no
    variable's statistics part by more than the seeds' spread; the port
    loaded from JAX's init through interop gives JAX's first forward."""
    out = tmp_path / "out"
    summary = torch_jax_lockstep.main([
        "--mode", "init", *SMALL, "--seeds", "0,1,2",
        "--workdir", str(tmp_path), "--out_dir", str(out)])
    assert summary["findings"] == []
    layers = _rows(out / "init_layers.csv")
    assert list(layers[0]) == ["variable", "statistic", "jax_mean",
                               "jax_range", "port_mean", "port_range",
                               "rel_gap", "finding"]
    stats = {(r["variable"], r["statistic"]) for r in layers}
    sn = "discriminator/B1/same_conv1/kernel"
    assert {(sn, "std"), (sn, "sigma_first"), (sn, "sigma_true")} <= stats
    forward = _rows(out / "init_forward.csv")
    assert [r["init"] for r in forward] == ["jax", "port",
                                            "port_from_jax"] * 3
    for jax_row, _, carried in zip(*[iter(forward)] * 3):
        for k in ("g_mean", "g_std", "logit_real_mean", "logit_fake_mean",
                  "d_hinge_loss"):
            th.assert_close(float(carried[k]), float(jax_row[k]),
                            rtol=1e-4, atol=1e-5, what=k)


def test_collapse_sweep_dry_run_writes_its_columns(tmp_path):
    """The card sweep's driver on the CPU: BigGAN-32 at ch 4, batch 2, two
    loops of 2 steps, one seed under the plain-attention variant."""
    out = tmp_path / "out"
    subprocess.run(
        [sys.executable, os.path.join(REPO, "tools",
                                      "torch_d_collapse_sweep.py"),
         "--variant", "plain_attention", "--seeds", "1", "--ch", "4",
         "--steps", "4", "--loop", "2", "--device", "cpu",
         "--gin_config", CONFIG32, "--gin_bindings", "options.batch_size = 2",
         "--n_train", "64", "--n_eval", "8", "--polygon_workers", "1",
         "--workdir", str(tmp_path / "w"), "--out_dir", str(out)],
        check=True, cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"))
    rows = _rows(out / "plain_attention.csv")
    assert list(rows[0]) == ["variant", "ch", "seed", "run", "step", "d_0",
                             "d_1", "g", "first_zero_loop", "s_per_step",
                             "card", "command"]
    assert [(r["variant"], r["ch"], r["seed"], r["step"]) for r in rows] == [
        ("plain_attention", "4", "1", "2"), ("plain_attention", "4", "1", "4")]
    assert all(np.isfinite(float(r[k])) for r in rows
               for k in ("d_0", "d_1", "g", "s_per_step"))
    assert rows[0]["card"] == "cpu"
    assert "run_config.tf_random_seed = 1" in rows[0]["command"]
    with open(out / "plain_attention.json") as f:
        record = json.load(f)
    run, = record["runs"]
    assert run["first_zero_loop"] is None and run["zero_loops"] == 0
    assert [loop["step"] for loop in run["losses"]] == [2, 4]
    assert run["launches"] == {"fwd": 0, "bwd": 0}
    assert len(run["digest"]) == 64


def test_trajectory_roundings_are_the_kernels_precision_and_bf16():
    x = torch.from_numpy(th.randn((4096,), 0, scale=3.0))
    rel = {name: float(((fn(torch, x) - x).abs() / x.abs()).max())
           for name, fn in (("hilo", chip_smoke._round_hilo),
                            ("bf16", chip_smoke._round_bf16))}
    assert 0 < rel["hilo"] <= 2.0 ** -16
    assert 2.0 ** -9 < rel["bf16"] <= 2.0 ** -8
    # Straight through: the rounded attention's gradient is the plain one's.
    theta, phi, g = (torch.from_numpy(th.randn(s, i)).requires_grad_()
                     for i, s in enumerate([(2, 8, 3), (2, 4, 3), (2, 4, 5)]))
    fn = chip_smoke._rounded_operands(
        torch, lambda *a: sum(t.sum() for t in a), chip_smoke._round_bf16)
    fn(theta, phi, g).backward()
    assert all(bool((t.grad == 1).all()) for t in (theta, phi, g))


def test_trajectory_gaps_are_relative_to_the_reference():
    init = {"w": torch.zeros(4)}
    ref = {"losses": [[1.0, 2.0, -1.0], [0.0, 0.0, 1.0]],
           "params": {"w": torch.ones(4)}}
    run = {"losses": [[1.0, 2.2, -1.0], [0.05, 0.0, 1.0]],
           "params": {"w": torch.tensor([1.0, 1.0, 1.0, 3.0])}}
    gaps = chip_smoke._trajectory_gaps(torch, run, ref, init)
    # 0.2 of 2.0; then 0.05 of a hinge loss at 0, over 1.
    np.testing.assert_allclose(gaps["loss_gaps"], [0.1, 0.05], rtol=1e-6)
    assert abs(gaps["rms_gap"] - 1.0) < 1e-6  # rms 1 of an update of rms 1
    bound = {"loss_gaps": [0.11, 0.06], "rms_gap": 1.1}
    assert chip_smoke._within(gaps, bound)
    for tighter in ({"loss_gaps": [0.11, 0.04], "rms_gap": 1.1},
                    {"loss_gaps": [0.11, 0.06], "rms_gap": 0.9}):
        assert not chip_smoke._within(gaps, tighter)

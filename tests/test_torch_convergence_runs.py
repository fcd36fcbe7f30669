"""The port's convergence-proof script (`tools/torch_convergence.py`) on
the CPU: each run's entry agrees with its published config, parsed by the
port's own gin; the script imports nothing of JAX, TensorFlow or the JAX
package; and an unconditional run (`dcgan28`) goes through the CLI and
every tool at a tiny size."""

import ast
import csv
import inspect
import json
import os
import sys

import pytest

from tests import torch_helpers  # noqa: F401 (one torch thread)
from tests.helpers import fake_inception

from compare_gan_torch import config as tgin
from compare_gan_torch import datasets, eval_utils, gans, polygons
from compare_gan_torch.gans import modular_gan
from tools import torch_convergence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "tools", "torch_convergence.py")


@pytest.fixture(autouse=True)
def _setup():
    tgin.clear_config()
    yield
    tgin.clear_config()


@pytest.mark.parametrize("run", sorted(torch_convergence.RUNS))
def test_run_entry_matches_its_config(run, tmp_path):
    """The config trains on the entry's dataset, its sets' writers write
    it (first) and the sets the tools read, and `conditional`/`ema` are
    the config's `<GAN>.conditional`/`<GAN>.g_use_ema`, or the GAN class's
    defaults where the file binds neither."""
    spec = torch_convergence.RUNS[run]
    assert gans.SSGAN  # The GAN classes are registered configurables.
    tgin.parse_config_files_and_bindings(
        [os.path.join(ROOT, "example_configs", spec["config"])], [])
    assert tgin.query("dataset.name") == spec["dataset"]
    gan_class = tgin.query("options.gan_class")
    defaults = inspect.signature(modular_gan.ModularGAN.__init__).parameters
    for field, param in (("conditional", "conditional"),
                         ("ema", "g_use_ema")):
        want = tgin.query(f"{gan_class.__name__}.{param}",
                          defaults[param].default)
        assert spec[field] == want, (field, gan_class.__name__)
    assert spec["predictor"] == bool(
        tgin.query(f"{gan_class.__name__}.use_predictor", False))
    assert spec["sets"][0] == spec["dataset"]
    if spec["predictor"]:
        assert set(torch_convergence.PROBE_SETS) <= set(spec["sets"])
    for name in spec["sets"]:
        out = polygons.WRITERS[name](str(tmp_path), n_train=5, n_test=2,
                                     n_holdout=1)
        assert out == os.path.join(str(tmp_path), name)
        assert sorted(os.listdir(out)) == [
            "holdout.npz", "test.npz", "train.npz"]


def test_the_script_imports_no_jax_or_tensorflow():
    """Every import of the script, at any depth, by its syntax tree."""
    with open(SCRIPT) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert "compare_gan_torch" in names
    for name in names:
        assert name.split(".")[0] not in (
            "jax", "jaxlib", "tensorflow", "compare_gan_tpu"), name


def test_dcgan28_dry_run_on_the_cpu(tmp_path, monkeypatch):
    """`--run dcgan28 --device cpu` at 4 steps on tiny sets: a scores row
    per checkpoint, a CSV per listed tag, the unconditional grids under
    the JAX proofs' names, and no tool in error."""
    for env in ("COMPARE_GAN_DATA_DIR", eval_utils.INCEPTION_NPZ_ENV):
        monkeypatch.setenv(env, "")
    monkeypatch.setattr(datasets, "DATA_DIR", datasets.DATA_DIR)
    monkeypatch.setitem(datasets.DATASETS, "convex_polygons",
                        datasets.DATASETS["convex_polygons"])
    monkeypatch.setattr(eval_utils, "_inception_fn", fake_inception)
    out = tmp_path / "out"
    monkeypatch.setattr(sys, "argv", [
        SCRIPT, "--run", "dcgan28", "--device", "cpu",
        "--workdir", str(tmp_path / "work"), "--out_dir", str(out),
        "--training_steps", "4", "--eval_every_steps", "2",
        "--dataset_sizes", "64,40,40", "--eval_test_samples", "32",
        "--anchor_per_split", "16", "--polygon_workers", "0",
        "--gin_bindings", "options.batch_size = 16",
        "--gin_bindings", "run_config.iterations_per_loop = 2",
        "--gin_bindings", "run_config.save_checkpoints_steps = 2"])
    torch_convergence.main()

    with open(out / "scores.csv") as f:
        assert [int(r["step"]) for r in csv.DictReader(f)] == [2, 4]
    traces = sorted(os.listdir(out / "loss_traces"))
    assert traces == ["loss_d_0.csv", "loss_g.csv", "loss_penalty.csv"]
    for step in (2, 4):
        assert (out / f"samples_step{step:05d}.png").exists()
    assert not list(out.glob("samples_per_class_*"))
    record = json.loads((out / "run.json").read_text())
    assert record["events_match_jsonl"] is True
    assert record["training_steps"] == 4
    assert set(record["tools"]) == {"fid_anchors", "tb_scalars",
                                    "demo_2", "demo_4"}
    assert not [k for k, v in record["tools"].items() if "error" in v]
    assert json.loads((out / "anchors.json").read_text())

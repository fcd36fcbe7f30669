"""The port's eval path against the JAX package's, f32 on the CPU: the BN
accumulator fill and EMA sampling on converted weights with injected z and
labels, module exports in both directions, scores.csv, checkpoint polling,
summaries, and the CLI's eval schedules.

RNG: the JAX package draws eval z and labels from PRNGKey(42) folded by run
and batch; the port from a torch.Generator per batch. The parity tests draw
with JAX and hand the draws to the port (`draw=`)."""

import csv
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers as th
from tests.helpers import fake_inception
from tests.test_torch_cli import BINDINGS

from compare_gan_tpu import checkpoint as jckpt
from compare_gan_tpu import config as jgin
from compare_gan_tpu import datasets as jdatasets
from compare_gan_tpu import eval_gan_lib as jeval
from compare_gan_tpu import export as jexport
from compare_gan_tpu import runner_lib as jrunner
from compare_gan_tpu import summaries as jsummaries
from compare_gan_tpu.gans import modular_gan as jmodular
from compare_gan_tpu.ops import rng as jrng
from compare_gan_tpu.utils import misc as jmisc
from compare_gan_torch import checkpoint as ckpt_lib
from compare_gan_torch import config as tgin
from compare_gan_torch import datasets, eval_gan_lib, eval_utils, export
from compare_gan_torch import interop, main, runner_lib, summaries, utils
from compare_gan_torch.gans import modular_gan
from compare_gan_torch.metrics import fid_score, inception_score

BATCH = 4
FILLS = 3
CFG = """
loss.fn = @hinge
penalty.fn = @no_penalty
weights.initializer = "orthogonal"
spectral_norm.singular_value = "auto"
standardize_batch.decay = 0.9
standardize_batch.epsilon = 1e-5
standardize_batch.use_moving_averages = False
ModularGAN.conditional = True
ModularGAN.g_use_ema = True
z.distribution_fn = @tf.random.normal
eval_z.distribution_fn = @tf.random.normal
G.batch_norm_fn = @conditional_batch_norm
G.spectral_norm = True
D.spectral_norm = True
resnet_biggan.Generator.ch = 4
resnet_biggan.Generator.blocks_with_attention = "B2"
resnet_biggan.Discriminator.ch = 4
"""
PARAMETERS = {"architecture": "resnet_biggan_arch", "z_dim": 16,
              "lambda": 1, "disc_iters": 2}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    tgin.clear_config()
    monkeypatch.delenv(eval_utils.INCEPTION_NPZ_ENV, raising=False)
    for module in (datasets, jdatasets):
        module.set_fake_dataset(True)
    yield
    for module in (datasets, jdatasets):
        module.set_fake_dataset(False)
    eval_utils.set_inception_fn(None)
    tgin.clear_config()


def _gans(model_dir="unused"):
    # The JAX side runs attention through its plain einsum reference (its
    # CPU default); the Pallas kernel is held against the port elsewhere.
    jgin.parse_config(CFG + "attention.use_pallas = False\n")
    tgin.parse_config(CFG)
    jgan = jmodular.ModularGAN(
        dataset=jdatasets.get_dataset("cifar10"), parameters=PARAMETERS,
        model_dir=model_dir)
    tgan = modular_gan.ModularGAN(
        dataset=datasets.get_dataset("cifar10"), parameters=PARAMETERS,
        model_dir=model_dir, device="cpu")
    return jgan, tgan


def _states(jgan, tgan):
    """The JAX init_state with the attention gates opened and EMA shadows
    that differ from the weights, and the port's TrainState holding the
    same values (converted by interop.py)."""
    ts_j = jax.jit(lambda key: jgan.init_state(key, BATCH))(
        jax.random.PRNGKey(0))

    def gated(tree, gate):
        return {k: (jnp.float32(gate) if k.endswith("non_local_block/sigma")
                    else v) for k, v in tree.items()}

    params = gated(ts_j.params, 0.5)
    ema = gated({k: v * 0.9 for k, v in ts_j.ema_params.items()}, 0.4)
    ts_j = dataclasses.replace(ts_j, params=params, ema_params=ema)
    ts_t = tgan.init_state(seed=1)
    interop.load_state_dict(ts_t, interop.params_from_jax(
        ts_j.params, ts_j.state, ts_j.ema_params))
    return ts_j, ts_t


def _jax_draws(jgan, key, n):
    """z and labels of n eval batches as the JAX package draws them."""
    draws = []
    for i in range(n):
        with jrng.rng_context(jax.random.fold_in(key, i)):
            z = jeval.z_generator([BATCH, jgan.z_dim], name="z")
            labels = jrng.randint([BATCH], 0, 10, name="labels")
        draws.append((np.asarray(z), np.asarray(labels)))
    return draws


def test_accumulator_fill_and_ema_samples_match_jax():
    """The fill sets `accu/update_accus`, runs G in eval mode with the EMA
    params committing state, and resets the switch: the accu/* sums and
    counters and the SN u vectors equal JAX's `_update_bn_accumulators`
    (1e-5; u 1e-4) on the JAX draws. Then eval-mode samples with the EMA
    params and the filled statistics equal JAX's `gan.sample` (1e-4), and
    differ from the raw weights' samples."""
    jgan, tgan = _gans()
    ts_j, ts_t = _states(jgan, tgan)
    fill_draws = _jax_draws(jgan, jax.random.PRNGKey(42), FILLS)
    state_j, had = jeval._update_bn_accumulators(
        jgan, ts_j, BATCH, num_accu_examples=BATCH * FILLS)
    assert had
    assert eval_gan_lib._update_bn_accumulators(
        tgan, ts_t, BATCH, BATCH * FILLS,
        draw=lambda stream, i: fill_draws[i])
    state_t = interop.params_to_jax(interop.state_dict(ts_t))[1]
    assert set(state_t) == set(state_j)
    accus = [k for k in state_j if "/accu/" in k]
    assert accus and any(k.endswith("accu_counter") for k in accus)
    for name, value in state_j.items():
        if name.endswith("update_accus"):
            assert int(state_t[name]) == int(value) == 0, name
        elif name.endswith("accu_counter"):
            th.assert_close(state_t[name], value, rtol=1e-6, atol=0,
                            what=name)
            assert abs(float(value) - FILLS) < 1e-5
        elif "/accu/" in name:
            # Sums of 3 f32 batch moments through a few conv/BN layers.
            th.assert_close(state_t[name], value, rtol=1e-5, atol=1e-5,
                            what=name)
        else:
            # SN u: unit vectors from 3 more power iterations.
            th.assert_close(state_t[name], value, rtol=1e-4, atol=1e-5,
                            what=name)

    ts_j = dataclasses.replace(ts_j, state=state_j)
    z, labels = _jax_draws(jgan, jax.random.PRNGKey(7), 1)[0]
    want, _ = jax.jit(lambda ts, zz, yy: jgan.sample(ts, zz, labels=yy))(
        ts_j, z, labels)
    got = tgan.sample(ts_t, z, labels)
    assert tuple(got.shape) == (BATCH, 32, 32, 3)
    # f32 G forwards of ~15 layers on two CPU backends: 1e-4.
    th.assert_close(got, want, rtol=1e-4, atol=1e-5)
    raw = tgan.sample(ts_t, z, labels, use_ema=False)
    assert not np.allclose(th.np32(raw), th.np32(got), atol=1e-3)
    # The "disc" tag: D in eval mode with the raw params.
    want_d = jax.jit(lambda ts, x, yy: jgan.discriminate(ts, x, labels=yy))(
        ts_j, th.np32(got), labels)
    for g, w in zip(tgan.discriminate(ts_t, th.np32(got), labels), want_d):
        th.assert_close(g, w, rtol=1e-4, atol=1e-4)
    # Sampling commits nothing; the fill left the switch at 0.
    assert interop.params_to_jax(interop.state_dict(ts_t))[1].keys() == \
        state_t.keys()
    for name, value in interop.params_to_jax(
            interop.state_dict(ts_t))[1].items():
        assert np.array_equal(value, state_t[name]), name


def test_sample_needs_ema_shadows_when_asked():
    _, tgan = _gans()
    ts = tgan.init_state(seed=0)
    ts.ema_params = {}
    with pytest.raises(ValueError, match="no EMA shadows"):
        tgan.sample(ts, np.zeros((1, 16), np.float32), np.zeros(1, np.int64))


def test_exports_load_in_both_packages(tmp_path):
    """An export of the port loads in the JAX package's load_generator and
    load_discriminator and gives what the port's loaders give, and an export
    of the JAX package loads in the port's (1e-4; the export holds the EMA
    params and the state)."""
    jgan, tgan = _gans()
    ts_j, ts_t = _states(jgan, tgan)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    export.export_module(tgan, ts_t, port_dir)
    jexport.export_module(jgan, ts_j, jax_dir)
    with open(os.path.join(port_dir, "module_spec.json")) as f, \
            open(os.path.join(jax_dir, "module_spec.json")) as g:
        assert json.load(f) == json.load(g)
    with np.load(os.path.join(port_dir, "module.npz")) as a, \
            np.load(os.path.join(jax_dir, "module.npz")) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            th.assert_close(a[k], b[k], rtol=1e-6, atol=1e-7, what=k)
            assert a[k].dtype == b[k].dtype, k

    z, labels = _jax_draws(jgan, jax.random.PRNGKey(3), 1)[0]
    want_samples = tgan.sample(ts_t, z, labels)
    for export_dir in (port_dir, jax_dir):
        gen_t, spec = export.load_generator(export_dir, device="cpu")
        gen_j, _ = jexport.load_generator(export_dir)
        got, want = gen_t(z, labels), gen_j(z, labels)
        th.assert_close(got, want, rtol=1e-4, atol=1e-5, what=export_dir)
        th.assert_close(got, want_samples, rtol=1e-4, atol=1e-5)
        disc_t, _ = export.load_discriminator(export_dir, device="cpu")
        disc_j, _ = jexport.load_discriminator(export_dir)
        images = th.np32(got)
        for g, w in zip(disc_t(images, labels), disc_j(images, labels)):
            th.assert_close(g, w, rtol=1e-4, atol=1e-4)
        with pytest.raises(ValueError, match="labels"):
            gen_t(z)
    # The export's eval prior: `eval_z` normal from its own snapshot.
    latents = export.sample_z(spec, 5)
    assert latents.shape == (5, 16) and latents.dtype == np.float32


def test_evaluate_tfhub_module_scores_an_export(tmp_path):
    """An export evaluates with no checkpoint and no live config: its own
    snapshot builds G and draws z."""
    eval_utils.set_inception_fn(fake_inception)
    _, tgan = _gans()
    ts = tgan.init_state(seed=0)
    export.export_module(tgan, ts, str(tmp_path))
    tgin.clear_config()
    out = eval_gan_lib.evaluate_tfhub_module(
        str(tmp_path), [inception_score.InceptionScoreTask(),
                        fid_score.FIDScoreTask()],
        batch_size=64, num_averaging_runs=2, num_accu_examples=64,
        device="cpu")
    assert set(out) == {f"{m}_{s}" for m in ("inception_score", "fid_score")
                        for s in ("mean", "std", "list")}
    assert np.isfinite(out["fid_score_mean"])
    assert len(out["fid_score_list"].split("_")) == 2


def _operative_configs(model_dir):
    os.makedirs(model_dir, exist_ok=True)
    for step, lr in ((0, "0.0001"), (4, "0.0002")):
        with open(os.path.join(model_dir, f"operative_config-{step}.gin"),
                  "w") as f:
            f.write(f"ModularGAN.g_lr = {lr}\noptions.batch_size = 64\n"
                    f"z.distribution_fn = @tf.random.normal\n")


def test_scores_csv_is_byte_identical_to_the_jax_package(tmp_path):
    """Same result dicts and operative configs: the same file, byte for
    byte, through a union-header rewrite when a metric column appears."""
    rows = [
        ("/ckpt/model.ckpt-2.npz", {"fid_score_mean": 12.3456,
                                    "fid_score_list": "12.1_12.5"}, -1.0),
        ("/ckpt/model.ckpt-4.npz", {"fid_score_mean": 31337.0,
                                    "inception_score_mean": 31337.0},
         31337.0),
        ("/ckpt/model.ckpt-6.npz", {"fid_score_mean": float("nan"),
                                    "kid_score_mean": 0.25}, -1.0),
    ]
    files = []
    for name, cls in (("port", runner_lib.TaskManagerWithCsvResults),
                      ("jax", jrunner.TaskManagerWithCsvResults)):
        model_dir = str(tmp_path / name)
        _operative_configs(model_dir)
        tm = cls(model_dir)
        for path, result, default in rows:
            tm.add_eval_result(path, result, default)
        files.append((tm, os.path.join(model_dir, "scores.csv")))
    (port_tm, port_file), (jax_tm, jax_file) = files
    with open(port_file, "rb") as a, open(jax_file, "rb") as b:
        assert a.read() == b.read()
    assert port_tm.get_checkpoints_with_results() == \
        jax_tm.get_checkpoints_with_results() == {p for p, _, _ in rows}


@pytest.mark.parametrize("eval_every_steps", [None, 2, 5])
def test_unevaluated_checkpoints_match_the_jax_package(tmp_path,
                                                       eval_every_steps):
    """Same order (ascending step), same divisibility filter, results in
    scores.csv skipped, and both stop once TRAIN_DONE is there."""
    for step in (10, 0, 2, 4, 5):
        ckpt_lib.write_arrays(str(tmp_path), {".step": np.int32(step)}, step)
    runner_lib.TaskManager(str(tmp_path)).mark_training_done()
    port_tm = runner_lib.TaskManagerWithCsvResults(str(tmp_path))
    port_tm.add_eval_result(ckpt_lib.checkpoint_path(str(tmp_path), 4), {},
                            -1.0)
    jax_tm = jrunner.TaskManagerWithCsvResults(str(tmp_path))
    got = list(port_tm.unevaluated_checkpoints(
        eval_every_steps=eval_every_steps, poll_interval_secs=0))
    want = list(jax_tm.unevaluated_checkpoints(
        eval_every_steps=eval_every_steps, poll_interval_secs=0))
    assert got == want
    assert [ckpt_lib.step_of(p) for p in got] == {
        None: [0, 2, 5, 10], 2: [2, 10], 5: [5, 10]}[eval_every_steps]
    assert all(jckpt.step_of(p) == ckpt_lib.step_of(p) for p in got)


@pytest.mark.parametrize("n,grid_shape", [(64, (8, 8)), (6, None),
                                          (70, (8, 8)), (5, (2, 4))])
def test_image_grid_equals_the_jax_package(n, grid_shape):
    images = np.random.RandomState(n).rand(n, 4, 3, 2).astype(np.float32)
    got = utils.image_grid(images, grid_shape=grid_shape)
    want = jmisc.image_grid(images, grid_shape=grid_shape)
    assert got.shape == want.shape and np.array_equal(got, want)


def _jax_jsonl_writer(model_dir, every):
    """The JAX package's writer on its JSONL fallback (its own test builds
    it this way: this machine has TensorFlow)."""
    w = jsummaries.SummaryWriter.__new__(jsummaries.SummaryWriter)
    w._model_dir, w._every, w._next_due = model_dir, every, every
    w._tf = w._tf_writer = None
    w._jsonl = open(os.path.join(model_dir, "summaries.jsonl"), "a")
    return w


def _rows(model_dir):
    with open(os.path.join(model_dir, "summaries.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_summaries_have_the_jax_fallback_keys_and_cadence(tmp_path):
    """Due-step cadence (250: writes at 300, 500, 800, 1000 when asked
    every 100 steps) and the JSONL rows' keys and values."""
    dirs = [str(tmp_path / d) for d in ("port", "jax")]
    for d in dirs:
        os.makedirs(d)
    writers = [summaries.SummaryWriter(dirs[0], 250),
               _jax_jsonl_writer(dirs[1], 250)]
    fired = []
    for w in writers:
        fired.append([])
        for step in range(100, 1001, 100):
            w.scalars({"loss/g": 0.5 * step, "loss/d_0": np.float32(2)},
                      step)
            if w.should_write(step):
                assert w.should_write(step)  # A pure predicate.
                w.image_grid("fake_images",
                             np.random.rand(6, 4, 4, 3), step)
                w.mark_written(step)
        w.close()
    assert fired[0] == fired[1]
    got, want = _rows(dirs[0]), _rows(dirs[1])
    assert len(got) == len(want) == 24
    assert [r.get("image_shape") for r in got if "image_shape" in r] == [
        [8, 12, 3]] * 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert {k: v for k, v in g.items() if k != "time"} == \
            {k: v for k, v in w.items() if k != "time"}


def _argv(model_dir, schedule, *extra):
    return ([f"--model_dir={model_dir}", f"--schedule={schedule}",
             "--device=cpu", "--data_fake_dataset", "--eval_every_steps=0"]
            + [f"--gin_bindings={b}" for b in BINDINGS]
            + ["--gin_bindings=evaluation.num_accu_examples = 128"]
            + list(extra))


def _scores(model_dir):
    with open(os.path.join(model_dir, "scores.csv"), newline="") as f:
        return list(csv.DictReader(f))


def test_train_writes_scalar_and_image_summaries(tmp_path):
    """Scalars every loop (the loop's mean losses) and the fixed-z image
    grid when due: 6 samples (batch 2 x 3 sub-steps) in a 2x3 grid."""
    tgin.parse_config("\n".join(BINDINGS))
    run_config = runner_lib.RunConfig(
        model_dir=str(tmp_path), iterations_per_loop=1,
        save_checkpoints_steps=1, save_summary_steps=2, device="cpu")
    report = runner_lib.run_with_schedule(
        "train", run_config, runner_lib.TaskManager(str(tmp_path)),
        runner_lib.get_options_dict())
    rows = _rows(str(tmp_path))
    scalars = [r for r in rows if "value" in r]
    assert [(r["step"], r["tag"]) for r in scalars] == [
        (s, t) for s in (1, 2) for t in report.metrics[0]]
    for r in scalars:
        assert r["value"] == pytest.approx(report.metrics[r["step"] - 1][
            r["tag"]], rel=1e-6)
    assert [r for r in rows if "image_shape" in r] == [
        {"step": 2, "tag": "fake_images", "image_shape": [64, 96, 3]}]


def test_cli_eval_after_train_writes_a_row_an_export_and_the_filled_state(
        tmp_path):
    """Train 2 steps, then eval every checkpoint past 0 with a fake
    Inception: a finite scores.csv row per step, the module export and the
    accumulator-filled TrainState in tfhub/<step> (switch at 0, two fill
    batches of 64 counted). A second eval finds nothing left to do."""
    eval_utils.set_inception_fn(fake_inception)
    report = main.main(_argv(tmp_path, "eval_after_train"))
    assert report.steps == [1, 2]
    assert [r["step"] for r in report.evals] == [1, 2]
    rows = _scores(tmp_path)
    assert [r["step"] for r in rows] == ["1", "2"]
    for row in rows:
        for key in ("fid_score_mean", "inception_score_mean"):
            assert np.isfinite(float(row[key])), row
            assert float(row[key]) not in (31337.0, 4242.0)
        assert row["options.batch_size"] == "2"
        assert len(row["fid_score_list"].split("_")) == 3
    assert set(report.evals[0]["seconds"]) >= {
        "restore", "export", "fill", "save_accu", "sampling",
        "inception_fake", "inception_real", "metrics"}
    export_dir = tmp_path / "tfhub" / "2"
    for name in ("module_spec.json", "module.npz", "export_config.gin",
                 "model.ckpt-2.npz"):
        assert (export_dir / name).exists(), name
    with np.load(export_dir / "model.ckpt-2.npz") as data:
        switches = [k for k in data.files if k.endswith("update_accus']")]
        assert switches and all(int(data[k]) == 0 for k in switches)
        for k in data.files:
            if k.endswith("accu_counter']"):
                assert abs(float(data[k]) - 2) < 1e-6, k
    with np.load(export_dir / "module.npz") as data:
        # The export precedes the fill, as in the JAX package.
        assert all(float(data[k]) < 1e-6 for k in data.files
                   if k.endswith("accu_counter"))
    tgin.clear_config()
    again = main.main(_argv(tmp_path, "eval_after_train"))
    assert again.evals == [] and len(_scores(tmp_path)) == 2


def test_cli_nan_weights_give_the_sentinel_row(tmp_path):
    """NaN in the sampled images: every metric column of that
    checkpoint's row is 31337.0; the other checkpoint scores normally."""
    eval_utils.set_inception_fn(fake_inception)
    main.main(_argv(tmp_path, "train"))
    path = tmp_path / "model.ckpt-2.npz"
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    key = ".ema_params['generator/final_conv/kernel']"
    arrays[key] = np.full_like(arrays[key], np.nan)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    tgin.clear_config()
    main.main(_argv(tmp_path, "eval_after_train"))
    rows = {r["step"]: r for r in _scores(tmp_path)}
    assert float(rows["1"]["fid_score_mean"]) != 31337.0
    for metric in ("fid_score", "inception_score"):
        for suffix in ("mean", "std", "list"):
            assert float(rows["2"][f"{metric}_{suffix}"]) == 31337.0


def test_cli_continuous_eval_stops_on_train_done(tmp_path):
    """continuous_eval evaluates what is there and returns once TRAIN_DONE
    is written and no checkpoint is left; it trains nothing."""
    eval_utils.set_inception_fn(fake_inception)
    main.main(_argv(tmp_path, "train"))
    tgin.clear_config()
    report = main.main(_argv(tmp_path, "continuous_eval"))
    assert report.steps == [] and [r["step"] for r in report.evals] == [1, 2]
    tgin.clear_config()
    again = main.main(_argv(tmp_path, "continuous_eval"))
    assert again.evals == [] and len(_scores(tmp_path)) == 2


@pytest.mark.parametrize("schedule", ["eval_after_train", "continuous_eval"])
def test_eval_builds_one_train_state_per_run(tmp_path, monkeypatch,
                                             schedule):
    """eval_after_train restores its checkpoints into training's own
    TrainState, and continuous_eval builds one for all of its checkpoints:
    one `init_state` in the whole run either way, and the report lets go
    of the TrainState. On the CPU no phase has a device peak."""
    eval_utils.set_inception_fn(fake_inception)
    if schedule == "continuous_eval":
        main.main(_argv(tmp_path, "train"))
        tgin.clear_config()
    built = []
    init_state = modular_gan.ModularGAN.init_state

    def counted(self, *args, **kwargs):
        built.append(args)
        return init_state(self, *args, **kwargs)

    monkeypatch.setattr(modular_gan.ModularGAN, "init_state", counted)
    report = main.main(_argv(tmp_path, schedule))
    assert len(built) == 1
    assert report.state is None
    assert [r["step"] for r in report.evals] == [1, 2]
    assert all(r["peak_bytes"] == {} for r in report.evals)


def test_phase_log_sums_the_seconds_of_a_repeated_phase():
    log = eval_gan_lib.PhaseLog()
    cpu = torch.device("cpu")
    for _ in range(3):
        with log.phase("sampling", cpu):
            pass
    with log.phase("metrics", cpu):
        pass
    assert list(log.seconds) == ["sampling", "metrics"]
    assert all(v >= 0 for v in log.seconds.values())
    assert log.peak_bytes == {}


def test_eval_without_an_inception_extractor_raises(tmp_path):
    """No test hook and no $COMPARE_GAN_INCEPTION_NPZ: the JAX package's
    RuntimeError, and no row."""
    with pytest.raises(RuntimeError, match="No Inception feature extractor"):
        main.main(_argv(tmp_path, "eval_after_train"))
    assert not (tmp_path / "scores.csv").exists()

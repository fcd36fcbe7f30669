"""The port's convergence-proof tools that evaluate networks against the JAX
package's, f32 on the CPU: `fid_anchors` on one random-weight Inception
`.npz` (numpy seed) read by both packages; `eval_ema_vs_raw` on the same
two checkpoints (BigGAN-32 at ch 4, converted by interop.py) with the JAX
package's eval draws handed to the port, and a control that reuses the EMA
view's filled accumulators; `s3gan_predictor_eval` on JAX S3GAN-32
checkpoints at narrow width loaded through interop.py."""

import copy
import csv
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers as th
from tests.helpers import fake_inception
from tests.test_torch_ssgan_s3gan import S3GAN_CFG
from tests.test_torch_tools import _inception_npz_weights

from compare_gan_tpu import checkpoint as jckpt
from compare_gan_tpu import config as jgin
from compare_gan_tpu import core as jcore
from compare_gan_tpu import datasets as jdatasets
from compare_gan_tpu import eval_gan_lib as jeval
from compare_gan_tpu import eval_utils as jeval_utils
from compare_gan_tpu.gans import modular_gan as jmodular
from compare_gan_tpu.gans import s3gan as js3gan
from compare_gan_tpu.ops import rng as jrng
from compare_gan_torch import checkpoint as ckpt_lib
from compare_gan_torch import config as tgin
from compare_gan_torch import datasets, eval_gan_lib, eval_utils, interop
from compare_gan_torch import polygons
from compare_gan_torch.gans import modular_gan, s3gan
from compare_gan_torch.metrics import fid_score
from compare_gan_torch.tools import eval_ema_vs_raw, fid_anchors
from compare_gan_torch.tools import s3gan_predictor_eval
from tools import eval_ema_vs_raw as jeval_ema_vs_raw
from tools import fid_anchors as jfid_anchors
from tools import s3gan_predictor_eval as js3gan_predictor_eval


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with th.one_blas_thread():
        yield


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    tgin.clear_config()
    for module in (eval_utils, jeval_utils):
        monkeypatch.delenv(module.INCEPTION_NPZ_ENV, raising=False)
        module.set_inception_fn(None)
    monkeypatch.setattr(datasets, "DATA_DIR", datasets.DATA_DIR)
    monkeypatch.setattr(jdatasets, "DATA_DIR", jdatasets.DATA_DIR)
    yield
    for module in (eval_utils, jeval_utils):
        module.set_inception_fn(None)
    for module in (datasets, jdatasets):
        module.set_fake_dataset(False)
    tgin.clear_config()


def test_fid_anchors_match_the_jax_tool(tmp_path, monkeypatch):
    """Both anchors within 1e-4 of the JAX tool's: the same splits, noise
    and Inception weights (features within ~1e-5 of each other), the same
    f64 FID."""
    npz = str(tmp_path / "inception.npz")
    np.savez(npz, **_inception_npz_weights(0))
    data_dir = str(tmp_path / "data")
    polygons.write_multiclass_npz_dataset(data_dir, n_train=4, n_test=8,
                                          n_holdout=8)
    monkeypatch.setenv("COMPARE_GAN_DATA_DIR", data_dir)
    monkeypatch.setenv(eval_utils.INCEPTION_NPZ_ENV, npz)
    want = jfid_anchors.compute_anchors("convex_polygons_multiclass",
                                        max_per_split=8)
    got = fid_anchors.compute_anchors("convex_polygons_multiclass",
                                      max_per_split=8, device="cpu")
    assert got["dataset"] == want["dataset"]
    assert got["num_per_split"] == want["num_per_split"] == 8
    for key in ("real_vs_real", "real_vs_noise"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   err_msg=key)
    assert 0 < got["real_vs_real"] < got["real_vs_noise"]


# eval_ema_vs_raw: BigGAN-32 at ch 4, conditional, with BN accumulators
# and a non-local block in G (test_torch_eval.py's configuration).
EMA_CFG = """
loss.fn = @hinge
penalty.fn = @no_penalty
weights.initializer = "orthogonal"
spectral_norm.singular_value = "auto"
standardize_batch.decay = 0.9
standardize_batch.epsilon = 1e-5
standardize_batch.use_moving_averages = False
ModularGAN.conditional = True
ModularGAN.g_use_ema = True
ModularGAN.ema_start_step = 1
z.distribution_fn = @tf.random.normal
eval_z.distribution_fn = @tf.random.normal
G.batch_norm_fn = @conditional_batch_norm
G.spectral_norm = True
D.spectral_norm = True
resnet_biggan.Generator.ch = 4
resnet_biggan.Generator.blocks_with_attention = "B2"
resnet_biggan.Discriminator.ch = 4
"""
EMA_PARAMETERS = {"architecture": "resnet_biggan_arch", "z_dim": 16,
                  "lambda": 1, "disc_iters": 2}
BATCH, FILLS, STEPS = 16, 2, (2, 4)


def _jax_eval_draw(jgan):
    """The port's `draw` that hands it the JAX package's eval z and labels:
    the fill's batch i from PRNGKey(42) folded by i, averaging run r's
    from PRNGKey(42) folded by r, then i."""
    base = jax.random.PRNGKey(42)

    def draw(stream, i):
        key = (jax.random.fold_in(base, i) if stream == "accu" else
               jax.random.fold_in(jax.random.fold_in(
                   base, int(stream[len("run"):])), i))
        with jrng.rng_context(key):
            z = jeval.z_generator([BATCH, jgan.z_dim], name="z")
            labels = jrng.randint([BATCH], 0, jgan.dataset.num_classes,
                                  name="labels")
        return np.asarray(z), np.asarray(labels)

    return draw


@pytest.fixture
def ema_run(tmp_path):
    """(jgan, tgan, JAX model_dir, port model_dir): checkpoints at steps 2
    and 4 in each, holding the same values; the raw weights move away from
    the EMA shadows (the port's init) step by step, and the attention
    gates are open."""
    for module in (datasets, jdatasets):
        module.set_fake_dataset(True)
    eval_utils.set_inception_fn(fake_inception)
    jeval_utils.set_inception_fn(fake_inception)
    jgin.parse_config(EMA_CFG + "attention.use_pallas = False\n")
    tgin.parse_config(EMA_CFG)
    dirs = str(tmp_path / "jax"), str(tmp_path / "port")
    jgan = jmodular.ModularGAN(dataset=jdatasets.get_dataset("cifar10"),
                               parameters=EMA_PARAMETERS, model_dir=dirs[0])
    tgan = modular_gan.ModularGAN(dataset=datasets.get_dataset("cifar10"),
                                  parameters=EMA_PARAMETERS,
                                  model_dir=dirs[1], device="cpu")
    ts_t = tgan.init_state(seed=1)
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for k, v in ts_t.ema_params.items():
            if k.endswith("non_local_block/sigma"):
                v.fill_(0.4)
    for step in STEPS:
        with torch.no_grad():
            for k, p in ts_t.generator.jax_variables()[0].items():
                if k.endswith("non_local_block/sigma"):
                    p.fill_(0.5)
                else:
                    p.add_(torch.from_numpy(th.randn(
                        p.shape, rng.randint(1 << 30), 0.05)))
        ts_t.step = step
        ckpt_lib.save_checkpoint(dirs[1], ts_t, step)
        ts_j = dataclasses.replace(th.jax_train_state(jgan, ts_t),
                                   step=jnp.int32(step))
        jckpt.save_checkpoint(dirs[0], ts_j, step)
    # The JAX tool restores into a template built by an eager init (tens
    # of seconds on the CPU); any TrainState of the config serves.
    jeval._jit_cache(jgan)[("template", BATCH)] = ts_j
    return jgan, tgan, dirs[0], dirs[1]


def test_ema_vs_raw_matches_the_jax_tool(ema_run, tmp_path):
    """Rows for steps 2 and 4 (step 0 is not there to skip), each FID
    within 1e-3 relative of the JAX tool's, the two views apart; the CSV
    rewritten with both rows. The real features are computed once."""
    jgan, tgan, jax_dir, port_dir = ema_run
    want = jeval_ema_vs_raw.evaluate_model_dir(
        jgan, jax_dir, batch_size=BATCH, num_accu_examples=BATCH * FILLS)
    out = str(tmp_path / "ema_vs_raw.csv")
    cache = eval_gan_lib.EvalCache()
    got = eval_ema_vs_raw.evaluate_model_dir(
        tgan, port_dir, batch_size=BATCH, out_path=out,
        num_accu_examples=BATCH * FILLS, draw=_jax_eval_draw(jgan),
        cache=cache)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [2, 4]
    for g, w in zip(got, want):
        for key in ("fid_ema", "fid_raw"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-3,
                                       err_msg=f"step {g['step']} {key}")
        assert abs(g["fid_ema"] - g["fid_raw"]) > 1e-2 * g["fid_raw"]
    assert len(cache.real) == 1
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows] == [2, 4]
    assert float(rows[1]["fid_raw"]) == got[1]["fid_raw"]
    # Neither view wrote a filled state into tfhub/<step>.
    assert not os.path.exists(os.path.join(port_dir, "tfhub"))


def test_raw_view_on_ema_filled_accumulators_is_caught(ema_run):
    """The control: a raw view that skips its own restore and fills on top
    of the accumulators the EMA view filled scores the raw G with the
    wrong statistics, and misses the JAX tool's raw FID by far more than
    the parity tolerance."""
    jgan, tgan, jax_dir, port_dir = ema_run
    want = jeval_ema_vs_raw.evaluate_model_dir(
        jgan, jax_dir, batch_size=BATCH, num_accu_examples=BATCH * FILLS)
    draw = _jax_eval_draw(jgan)
    path = ckpt_lib.checkpoint_path(port_dir, STEPS[-1])
    cache = eval_gan_lib.EvalCache()
    ts = eval_gan_lib.restored_state(tgan, path, cache)
    task = fid_score.FIDScoreTask()
    kwargs = dict(batch_size=BATCH, num_accu_examples=BATCH * FILLS,
                  draw=draw, cache=cache, export_accu_checkpoint=False)
    eval_gan_lib.evaluate_checkpoint(tgan, path, [task], ts=ts, **kwargs)
    raw_gan = copy.copy(tgan)
    raw_gan._g_use_ema = False
    reused = eval_gan_lib.evaluate_checkpoint(raw_gan, path, [task], ts=ts,
                                              **kwargs)["fid_score_mean"]
    own = eval_gan_lib.evaluate_checkpoint(raw_gan, path, [task],
                                           **kwargs)["fid_score_mean"]
    np.testing.assert_allclose(own, want[-1]["fid_raw"], rtol=1e-3)
    assert not np.isclose(reused, want[-1]["fid_raw"], rtol=1e-2)


def test_module_export_holds_the_training_accumulators(ema_run, tmp_path):
    """An open fault shared with the JAX package (ROADMAP Queue 3): the
    eval writes `tfhub/<step>` before it fills the BN accumulators, so the
    export's are the training state's (count 1e-12) and its G in eval mode
    divides each BN input by sqrt(epsilon): saturated images (at 128 px on
    the card, NaN). `tools/torch_convergence.py`'s `filled_export` exports
    the filled checkpoint instead, whose G gives images in between."""
    from compare_gan_torch import export
    from tools import torch_convergence
    _, tgan, _, port_dir = ema_run
    path = ckpt_lib.checkpoint_path(port_dir, STEPS[-1])
    cache = eval_gan_lib.EvalCache()
    ts = eval_gan_lib.restored_state(tgan, path, cache)
    tfhub = os.path.join(port_dir, "tfhub", str(STEPS[-1]))
    export.export_module(tgan, ts, tfhub)  # As runner_lib does.
    eval_gan_lib.evaluate_checkpoint(tgan, path, [], batch_size=BATCH,
                                     num_accu_examples=BATCH * FILLS,
                                     ts=ts, cache=cache)
    config = tmp_path / "ema.gin"
    config.write_text(EMA_CFG + """
dataset.name = "cifar10"
options.gan_class = @ModularGAN
options.architecture = "resnet_biggan_arch"
options.batch_size = 16
options.training_steps = 4
options.z_dim = 16
options.disc_iters = 2
""")
    filled = torch_convergence.filled_export(str(config), [], port_dir,
                                             STEPS[-1], "cpu")
    counters = {}
    for name, d in (("tfhub", tfhub), ("filled", filled)):
        with np.load(os.path.join(d, "module.npz")) as data:
            counters[name] = {k: float(data[k]) for k in data.files
                              if k.endswith("accu_counter")}
    assert counters["tfhub"] and set(counters["tfhub"].values()) == {
        np.float32(1e-12)}
    assert set(counters["filled"].values()) == {np.float32(FILLS + 1e-12)}
    z = np.random.RandomState(0).randn(8, 16).astype(np.float32)
    labels = np.arange(8) % 10
    saturated = {}
    for name, d in (("tfhub", tfhub), ("filled", filled)):
        generate, _ = export.load_generator(d, "cpu")
        images = generate(z, labels).numpy()
        assert np.isfinite(images).all()
        saturated[name] = np.isin(images, (0.0, 1.0)).mean()
    assert saturated["tfhub"] > 0.9 and saturated["filled"] < 0.1


def test_ema_vs_raw_refuses_a_run_without_ema(tmp_path):
    datasets.set_fake_dataset(True)
    tgin.parse_config(EMA_CFG + "ModularGAN.g_use_ema = False\n")
    tgan = modular_gan.ModularGAN(dataset=datasets.get_dataset("cifar10"),
                                  parameters=EMA_PARAMETERS,
                                  model_dir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="without g_use_ema"):
        eval_ema_vs_raw.evaluate_model_dir(tgan, str(tmp_path))


# s3gan_predictor_eval: S3GAN-32 at ch 4 with the heads of
# s3gan32_polygons_partial_oriented.gin, on a small oriented polygon set
# (32 px, one channel, 4 classes, 20% of train labels).
S3GAN_HEADS = dict(conditional=True, self_supervision="rotation",
                   rotated_batch_fraction=2, project_y=True,
                   use_predictor=True, use_soft_pred=True)
S3GAN_PARAMETERS = {"architecture": "resnet_biggan_arch", "z_dim": 16,
                    "lambda": 1, "disc_iters": 2}
DATASET = "convex_polygons_partial_oriented"
PREDICTOR_KERNEL = "discriminator_predictor/predictor_linear/kernel"


@pytest.fixture(scope="module")
def s3gan_files(tmp_path_factory):
    """The data and the checkpoints, built once: (data_dir, JAX model_dir,
    port model_dir, the JAX TrainState at step 1 as a restore template).
    Checkpoints at steps 0 (the JAX init) and 1 (its predictor kernel
    redrawn), the same values in both packages."""
    tmp_path = tmp_path_factory.mktemp("s3gan")
    data_dir = str(tmp_path / "data")
    polygons.write_partial_oriented_npz_dataset(data_dir, n_train=64,
                                                n_test=96, n_holdout=8)
    jgan, tgan = _s3gan_gans(data_dir)
    dirs = str(tmp_path / "jax"), str(tmp_path / "port")
    ts_j = jax.jit(lambda key: jgan.init_state(key, 8))(
        jax.random.PRNGKey(0))
    ts_t = tgan.init_state(seed=1)
    for step in (0, 1):
        if step:
            kernel = ts_j.params[PREDICTOR_KERNEL]
            ts_j = dataclasses.replace(ts_j, params={
                **ts_j.params, PREDICTOR_KERNEL: jnp.asarray(th.randn(
                    kernel.shape, 5, 3.0))})
        jckpt.save_checkpoint(dirs[0], ts_j, step)
        interop.load_state_dict(ts_t, interop.params_from_jax(
            ts_j.params, ts_j.state, ts_j.ema_params))
        ts_t.step = step
        ckpt_lib.save_checkpoint(dirs[1], ts_t, step)
    tgin.clear_config()
    jgin.clear_config()
    return data_dir, dirs[0], dirs[1], ts_j


def _s3gan_gans(data_dir):
    """Both packages' S3GAN on the oriented set in `data_dir` (gin parsed
    here; the caller's autouse fixtures clear it)."""
    datasets.DATA_DIR = jdatasets.DATA_DIR = data_dir
    jgin.parse_config(S3GAN_CFG + "attention.use_pallas = False\n")
    tgin.parse_config(S3GAN_CFG)
    jgan = js3gan.S3GAN(dataset=jdatasets.get_dataset(DATASET),
                        parameters=S3GAN_PARAMETERS, model_dir="unused",
                        **S3GAN_HEADS)
    tgan = s3gan.S3GAN(dataset=datasets.get_dataset(DATASET),
                       parameters=S3GAN_PARAMETERS, model_dir="unused",
                       device="cpu", **S3GAN_HEADS)
    return jgan, tgan


@pytest.fixture
def s3gan_run(s3gan_files, monkeypatch):
    """(jgan, tgan, JAX restore template, (JAX model_dir, port model_dir))
    with the data directory set for this test."""
    data_dir, jax_dir, port_dir, template = s3gan_files
    for module in (datasets, jdatasets):
        monkeypatch.setattr(module, "DATA_DIR", data_dir)
    monkeypatch.setenv("COMPARE_GAN_DATA_DIR", data_dir)
    jgan, tgan = _s3gan_gans(data_dir)
    return jgan, tgan, template, (jax_dir, port_dir)


def test_predictor_eval_matches_the_jax_tool(s3gan_run):
    """The same held-out split (96 test examples, unshuffled); per
    checkpoint the aux logits within 1e-4 of JAX's on the port's images and
    the same accuracy, over the whole batches only (96 // 64: the first
    64)."""
    jgan, tgan, template, (jax_dir, port_dir) = s3gan_run
    images, labels = s3gan_predictor_eval.load_labeled_split(
        tgan.dataset, "test", 96)
    want_images, want_labels = js3gan_predictor_eval.load_labeled_split(
        jgan.dataset, "test", 96)
    # uint8 / 255 in each package's source: one f32 ulp apart at most.
    np.testing.assert_allclose(images, want_images, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(labels, want_labels)
    assert (labels >= 0).all() and len(labels) == 96

    @jax.jit
    def jax_aux(params, state, x):
        def fwd():
            y = np.zeros((x.shape[0], jgan.dataset.num_classes), np.float32)
            return jgan.discriminator_with_additonal_heads(
                x=x, y=y, is_training=False)[3]
        return jcore.apply(fwd, params, state)[0]

    rows = s3gan_predictor_eval.evaluate_model_dir(tgan, port_dir, images,
                                                   labels, batch_size=64)
    assert [r["step"] for r in rows] == [0, 1]
    accuracies = []
    port_template = tgan.init_state(0)
    for path, row in zip(jckpt.all_checkpoints(jax_dir), rows):
        ts_j = jckpt.restore_checkpoint(path, template)
        ckpt_lib.restore_checkpoint(
            ckpt_lib.checkpoint_path(port_dir, row["step"]), port_template)
        got = s3gan_predictor_eval.aux_logits(tgan, images)
        want = jax_aux(ts_j.params, ts_j.state, images)
        th.assert_close(got, want, rtol=1e-4, atol=1e-4)
        acc = js3gan_predictor_eval.predictor_accuracy(
            jgan, ts_j, images, labels, batch_size=64)
        assert row["predictor_accuracy"] == f"{acc:.4f}"
        assert s3gan_predictor_eval.predictor_accuracy(
            tgan, images, labels, batch_size=64) == acc
        assert row["num_examples"] == 96 and row["chance"] == "0.2500"
        accuracies.append((acc, th.np32(got)))
    # The redrawn predictor changed the logits (two random heads may score
    # the same accuracy).
    assert np.abs(accuracies[0][1] - accuracies[1][1]).max() > 1e-2


def _write_config(tmp_path, extra=""):
    path = tmp_path / "s3gan.gin"
    path.write_text(S3GAN_CFG + f"""
dataset.name = "{DATASET}"
options.gan_class = @S3GAN
options.architecture = "resnet_biggan_arch"
options.batch_size = 8
options.training_steps = 1
options.z_dim = 16
options.disc_iters = 2
S3GAN.conditional = True
S3GAN.self_supervision = "rotation"
S3GAN.rotated_batch_fraction = 2
S3GAN.project_y = True
S3GAN.use_predictor = True
S3GAN.use_soft_pred = True
""" + extra)
    return str(path)


def test_predictor_eval_cli_writes_a_row_per_checkpoint(s3gan_run, tmp_path):
    _, _, _, (_, port_dir) = s3gan_run
    tgin.clear_config()
    out = str(tmp_path / "predictor_accuracy.csv")
    rows = s3gan_predictor_eval.main([
        f"--model_dir={port_dir}", "--gin_config", _write_config(tmp_path),
        "--num_examples=96", f"--out_csv={out}", "--device=cpu"])
    with open(out) as f:
        written = list(csv.DictReader(f))
    assert [int(r["step"]) for r in written] == [0, 1]
    assert list(written[0]) == ["step", "predictor_accuracy", "split",
                                "num_examples", "chance"]
    assert [r["predictor_accuracy"] for r in written] == \
        [r["predictor_accuracy"] for r in rows]


@pytest.mark.parametrize("split,extra,message", [
    ("train", "", "unlabeled examples"),
    ("test", "S3GAN.use_predictor = False\n", "no predictor head")])
def test_predictor_eval_refusals(s3gan_run, tmp_path, split, extra,
                                 message):
    """A split with unlabeled rows (the train split keeps 20% of its
    labels), and a model without a predictor, are refused."""
    _, _, _, (_, port_dir) = s3gan_run
    tgin.clear_config()
    with pytest.raises(SystemExit, match=message):
        s3gan_predictor_eval.main([
            f"--model_dir={port_dir}", "--gin_config",
            _write_config(tmp_path, extra), f"--split={split}",
            "--num_examples=64", "--device=cpu"])

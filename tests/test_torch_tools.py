"""The port's convergence-proof tools (compare_gan_torch/tools) against the
JAX package's (tools/*.py) on the CPU, and the port's TensorBoard event
files against TensorFlow's reader: `tb_scalars` on one model_dir holding
JSONL rows and event files; the event files of the port's SummaryWriter,
read back by TensorFlow and listed by TensorBoard; `rotation_probe`
trained from the same draws; and `validate_real_assets` on the synthetic
fixtures of its JAX test, with TensorFlow handed in as the second oracle.
The tests that need TensorFlow or TensorBoard skip where it is absent."""

import glob
import os
import sys

import jax
import numpy as np
import pytest

from tests import torch_helpers  # One torch thread.

from compare_gan_tpu import summaries as jsummaries
from compare_gan_torch import polygons, summaries
from compare_gan_torch.tf_io import events
from compare_gan_torch.tools import rotation_probe, tb_scalars
from compare_gan_torch.tools import validate_real_assets
from tools import rotation_probe as jrotation_probe
from tools import tb_scalars as jtb_scalars


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with torch_helpers.one_blas_thread():
        yield


def _tf():
    return pytest.importorskip("tensorflow")


def _write_jsonl(model_dir, rows):
    """Rows as the JAX package's JSONL fallback writes them."""
    import json
    with open(os.path.join(model_dir, "summaries.jsonl"), "a") as f:
        for step, tag, value in rows:
            f.write(json.dumps({"step": step, "tag": tag, "value": value,
                                "time": 0.0}) + "\n")


def _write_tf_event(tf, path, step, values):
    """One Event of `values` [(tag, simple_value or a numpy tensor)]
    written with TensorFlow's own protos and record writer."""
    from tensorflow.core.util import event_pb2
    summary = tf.compat.v1.Summary()
    for tag, value in values:
        if isinstance(value, np.ndarray):
            summary.value.add(tag=tag, tensor=tf.make_tensor_proto(value))
        else:
            summary.value.add(tag=tag, simple_value=value)
    event = event_pb2.Event(wall_time=1.0, step=step, summary=summary)
    with tf.io.TFRecordWriter(path) as w:
        w.write(event.SerializeToString())


def test_tb_scalars_gives_the_jax_tools_series_and_csv_bytes(tmp_path,
                                                             monkeypatch):
    """JSONL rows first, event rows second, a later (tag, step) winning: a
    restarted step carried by both forms takes the event file's value.
    Scalars come as rank-0 tensors or simple_value; string and rank-1
    tensors are skipped. Series equal, and the CSVs equal byte for byte."""
    tf = _tf()
    model_dir = tmp_path / "run"
    model_dir.mkdir()
    rng = np.random.RandomState(0)
    _write_jsonl(str(model_dir), [
        (step, tag, float(rng.rand())) for step in (250, 500, 750)
        for tag in ("loss/d_0", "loss/g")])
    writer = jsummaries.SummaryWriter(str(model_dir))
    for step in (750, 1000):  # 750: the restart, both forms carry it.
        writer.scalars({"loss/d_0": np.float32(rng.randn()),
                        "loss/g": np.float32(rng.randn())}, step)
    writer.image_grid("fake_images", rng.rand(4, 8, 8, 1), 1000)
    writer.close()
    _write_tf_event(tf, str(model_dir / "events.out.tfevents.0.host"), 1250,
                    [("loss/penalty", 0.25),
                     ("loss/pair", np.array([1.0, 2.0], np.float32)),
                     ("loss/g", np.array(3.5, np.float64))])

    got = tb_scalars.read_scalars(str(model_dir))
    want = jtb_scalars.read_scalars(str(model_dir))
    assert got == want
    assert sorted(got) == ["loss/d_0", "loss/g", "loss/penalty"]
    assert [s for s, _ in got["loss/g"]] == [250, 500, 750, 1000, 1250]
    with open(model_dir / "summaries.jsonl") as f:
        stale = [line for line in f if '"step": 750' in line]
    assert stale and all(str(v) not in "".join(stale)
                         for s, v in got["loss/d_0"] if s == 750)

    outs = {}
    for name, run in (("port", lambda argv: tb_scalars.main(argv)),
                      ("jax", None)):
        out_dir = str(tmp_path / name)
        argv = [f"--model_dir={model_dir}", f"--out_dir={out_dir}"]
        if run is None:
            monkeypatch.setattr(sys, "argv", ["tb_scalars.py"] + argv)
            assert jtb_scalars.main() == 0
        else:
            assert run(argv) == 0
        outs[name] = {os.path.basename(p): open(p, "rb").read()
                      for p in glob.glob(os.path.join(out_dir, "*.csv"))}
    assert sorted(outs["port"]) == ["loss_d_0.csv", "loss_g.csv",
                                    "loss_penalty.csv"]
    assert outs["port"] == outs["jax"]
    assert outs["port"]["loss_penalty.csv"] == b"step,penalty\r\n1250,0.25\r\n"


def _same_calls(writer, rng):
    """Scalars of several tags and steps, and gray and RGB image grids,
    as the trainer writes them."""
    for step in (1, 2, 250):
        writer.scalars({"loss/d_0": np.float32(rng.randn()),
                        "loss/g": np.float32(rng.randn() * 1e-3)}, step)
    grids = {"fake_images": rng.rand(64, 8, 8, 1).astype(np.float32),
             "fake_rgb": rng.rand(5, 6, 6, 3).astype(np.float32)}
    for tag, images in grids.items():
        writer.image_grid(tag, images, 250)
    writer.close()
    return grids


def _events_of(tf, model_dir):
    from tensorflow.core.util import event_pb2
    (path,) = glob.glob(os.path.join(model_dir, "events.out.tfevents.*"))
    return [event_pb2.Event.FromString(rec.numpy())
            for rec in tf.data.TFRecordDataset(path)]


def test_port_event_files_read_back_in_tensorflow(tmp_path):
    """The port's SummaryWriter writes `tf.summary`'s layout: TensorFlow's
    reader and protos give back every scalar exactly (a rank-0 float32
    tensor, plugin "scalars") and every grid as the PNG the JAX package's
    writer makes (the same pixels; width and height first), after a first
    event with the file version. The JSONL rows stay as they were."""
    tf = _tf()
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    grids = _same_calls(summaries.SummaryWriter(port_dir),
                        np.random.RandomState(1))
    _same_calls(jsummaries.SummaryWriter(jax_dir), np.random.RandomState(1))
    port, ref = _events_of(tf, port_dir), _events_of(tf, jax_dir)
    assert port[0].file_version == ref[0].file_version == "brain.Event:2"
    assert [e.step for e in port] == [e.step for e in ref]
    rng = np.random.RandomState(1)
    scalars = [(step, tag, np.float32(rng.randn() * scale))
               for step in (1, 2, 250)
               for tag, scale in (("loss/d_0", 1.0), ("loss/g", 1e-3))]
    got_scalars = []
    for got, want in zip(port[1:], ref[1:]):
        (g,), (w,) = got.summary.value, want.summary.value
        assert g.tag == w.tag
        assert g.metadata.plugin_data.plugin_name == \
            w.metadata.plugin_data.plugin_name
        value, ref_value = tf.make_ndarray(g.tensor), tf.make_ndarray(w.tensor)
        if g.metadata.plugin_data.plugin_name == "scalars":
            assert value.dtype == np.float32 and value.shape == ()
            assert value == ref_value
            got_scalars.append((got.step, g.tag, value))
        else:
            assert list(value[:2]) == list(ref_value[:2])
            image = tf.io.decode_png(value[2]).numpy()
            np.testing.assert_array_equal(
                image, tf.io.decode_png(ref_value[2]).numpy())
            from compare_gan_torch import utils
            images = grids[g.tag]
            grid = utils.image_grid(images, None if len(images) < 64
                                    else (8, 8))
            np.testing.assert_array_equal(image, events.image_to_uint8(grid))
            assert value[:2].tolist() == [str(grid.shape[1]).encode(),
                                          str(grid.shape[0]).encode()]
    assert got_scalars == scalars
    with open(os.path.join(port_dir, "summaries.jsonl")) as f:
        assert len(f.readlines()) == len(scalars) + len(grids)


def test_tensorboard_lists_the_same_tags(tmp_path):
    pytest.importorskip("tensorflow")
    accumulator = pytest.importorskip(
        "tensorboard.backend.event_processing.event_accumulator")
    tags = []
    for name, cls in (("port", summaries.SummaryWriter),
                      ("jax", jsummaries.SummaryWriter)):
        model_dir = str(tmp_path / name)
        _same_calls(cls(model_dir), np.random.RandomState(2))
        acc = accumulator.EventAccumulator(model_dir)
        acc.Reload()
        tags.append({k: sorted(v) if isinstance(v, list) else v
                     for k, v in acc.Tags().items()})
    assert tags[0] == tags[1]
    assert tags[0]["tensors"] == ["fake_images", "fake_rgb", "loss/d_0",
                                  "loss/g"]


def test_event_records_are_checked_and_read_without_tensorflow(tmp_path):
    """The port's own reader takes the file back, and refuses a record
    whose CRC does not match."""
    writer = summaries.SummaryWriter(str(tmp_path))
    writer.scalar("loss/g", 0.125, 7)
    writer.close()
    (path,) = glob.glob(str(tmp_path / "events.out.tfevents.*"))
    first, second = list(events.iter_events(path))
    assert first.file_version == "brain.Event:2"
    assert second.step == 7 and second.values[0].plugin == "scalars"
    assert tb_scalars.read_scalars(str(tmp_path)) == {"loss/g": [(7, 0.125)]}
    data = bytearray(open(path, "rb").read())
    data[-6] ^= 1  # A bit of the last payload.
    open(path, "wb").write(bytes(data))
    with pytest.raises(IOError, match="corrupted record payload"):
        list(events.iter_events(path))


def test_event_files_and_jsonl_rows_agree_until_one_form_differs(tmp_path):
    """`forms_agree` reads each form alone: the port's writer gives the
    same series in both (the event's float32 of the row's mean); a row the
    event files lack, or a value that is not that float32, breaks it."""
    writer = summaries.SummaryWriter(str(tmp_path))
    writer.scalars({"loss/d_0": 0.1, "loss/g": 1 / 3}, 4)
    writer.scalar("loss/g", 2.5, 8)
    writer.close()
    assert tb_scalars.forms_agree(str(tmp_path)) == (True,
                                                     ["loss/d_0", "loss/g"])
    with open(tmp_path / "summaries.jsonl", "a") as f:
        f.write('{"step": 9, "tag": "loss/g", "value": 0.1, "time": 0}\n')
    assert tb_scalars.forms_agree(str(tmp_path))[0] is False


# The rotation probe: one RandomState draws the shuffle, then the glorot
# weights; Adam at 1e-3; the sliding window over the task. 20 steps on 64
# images (a batch of 256 = the whole task), f32 on two CPU backends.
PROBE_STEPS, PROBE_TRAIN, PROBE_TEST = 20, 64, 32


@pytest.fixture
def probe_data(tmp_path, monkeypatch):
    data_dir = str(tmp_path / "data")
    for write in (polygons.write_partial_npz_dataset,
                  polygons.write_partial_oriented_npz_dataset):
        write(data_dir, n_train=PROBE_TRAIN, n_test=PROBE_TEST, n_holdout=8)
    monkeypatch.setenv("COMPARE_GAN_DATA_DIR", data_dir)


def _probe_both(dataset, monkeypatch):
    """(JAX tool's result, its parameters after the last step, caught at
    jax.jit; the port's result, its parameters in the JAX layout)."""
    jitted = jax.jit
    caught = {}

    def catching_jit(fn=None, **kwargs):
        if fn is None:
            return lambda f: catching_jit(f, **kwargs)
        compiled = jitted(fn, **kwargs)
        if fn.__name__ != "train_step":
            return compiled

        def call(*args):
            out = compiled(*args)
            caught["params"] = out[0]
            return out
        return call

    monkeypatch.setattr(jax, "jit", catching_jit)
    want = jrotation_probe.probe_dataset(dataset, n_train=PROBE_TRAIN,
                                         n_test=PROBE_TEST,
                                         steps=PROBE_STEPS)
    monkeypatch.setattr(jax, "jit", jitted)
    got, model = rotation_probe.train_probe(
        dataset, n_train=PROBE_TRAIN, n_test=PROBE_TEST, steps=PROBE_STEPS,
        device="cpu")
    assert {k: v for k, v in got.items() if "accuracy" not in k} == \
        {k: v for k, v in want.items() if "accuracy" not in k}
    # An argmax tie may fall either way: one example's share.
    for key, count in (("train_accuracy", 4 * PROBE_TRAIN),
                       ("test_accuracy", 4 * PROBE_TEST)):
        assert abs(got[key] - want[key]) <= 1.0 / count + 1e-9, key
    params = {k: np.asarray(v) for k, v in caught["params"].items()}
    return params, model.jax_params()


def test_rotation_probe_trains_as_the_jax_tool(probe_data, monkeypatch):
    """On the rotation-invariant set: parameters after training within
    1e-4 of the JAX tool's, and each accuracy within one example's
    share."""
    want, got = _probe_both("convex_polygons_partial", monkeypatch)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_rotation_probe_on_the_oriented_set(probe_data, monkeypatch):
    """On the oriented set each accuracy is within one example's share of
    the JAX tool's. Its parameters are not held to 1e-4: the ramp's rows
    are flat, so conv outputs that are equal in exact arithmetic meet in
    the 2x2 max-pool, XLA and oneDNN round them differently and route the
    gradient to different pixels, and Adam's normalized steps amplify
    that (measured: 3e-8 after one step, 2e-5 after 10, 1e-3 after 20 in
    conv2; 1e-4 after 20 with +-2 levels of noise added to the images).
    After one step, before any routing can compound, they agree to 1e-6."""
    want, got = _probe_both("convex_polygons_partial_oriented", monkeypatch)
    assert sorted(got) == sorted(want)
    monkeypatch.setattr(sys.modules[__name__], "PROBE_STEPS", 1)
    want, got = _probe_both("convex_polygons_partial_oriented", monkeypatch)
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def test_rotation_probe_starts_from_the_jax_tools_draws():
    """The draws in the JAX tool's order, and the HWIO kernels turned to
    OIHW and back."""
    rng = np.random.RandomState(3)
    rng.permutation(8)
    params = rotation_probe._init_cnn(rng, 1)
    ref_rng = np.random.RandomState(3)
    ref_rng.permutation(8)
    ref = jrotation_probe._init_cnn(ref_rng, 1)
    for name in ref:
        np.testing.assert_array_equal(params[name], ref[name])
    model = rotation_probe.ProbeCNN(params, "cpu")
    for name, value in model.jax_params().items():
        np.testing.assert_array_equal(value, params[name])
    images = (np.arange(2 * 4 * 4) % 7).reshape(2, 4, 4, 1).astype(np.uint8)
    for got, want in zip(rotation_probe.make_rotation_task(images),
                         jrotation_probe.make_rotation_task(images)):
        np.testing.assert_array_equal(got, want)


# validate_real_assets: the JAX kit's test cases on its synthetic
# fixtures, TensorFlow handed in as the second oracle.


def _tf_oracles(tf):
    from compare_gan_tpu import eval_utils as jeval_utils

    def features(pb_path, images):
        return jeval_utils._tf_frozen_graph_fn(pb_path)(images)

    def record(payload):
        feats = tf.train.Example.FromString(payload).features.feature
        encoded = feats["image/encoded"].bytes_list.value[0]
        return (tf.io.decode_image(encoded).numpy(),
                int(feats["label"].int64_list.value[0]))

    return {"tensorflow": features}, {"tensorflow": record}


def _inception_npz_weights(seed):
    """Random Inception weights from a numpy seed, in the .npz layout
    (He-scaled kernels, identity BN)."""
    from compare_gan_torch.metrics import inception_net
    rng = np.random.RandomState(seed)
    params = {}
    for name, shape in sorted(inception_net.param_shapes().items()):
        if name.endswith("moving_variance"):
            params[name] = np.ones(shape, np.float32)
        elif name.endswith(("beta", "moving_mean", "biases")):
            params[name] = np.zeros(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[:-1]))
            params[name] = (rng.randn(*shape)
                            * np.sqrt(2.0 / fan_in)).astype(np.float32)
    return params


@pytest.fixture
def kit_env(monkeypatch):
    from compare_gan_torch import datasets, eval_utils
    monkeypatch.delenv(eval_utils.INCEPTION_NPZ_ENV, raising=False)
    monkeypatch.delenv(eval_utils.INCEPTION_PB_ENV, raising=False)
    monkeypatch.setattr(datasets, "DATA_DIR", datasets.DATA_DIR)
    monkeypatch.setenv("COMPARE_GAN_DATA_DIR", "")
    eval_utils.set_inception_fn(None)


def test_kit_full_pass_on_synthetic_assets(tmp_path, kit_env):
    """Every check passes on the frozen-graph-shaped pb and the polygons
    npz set: the npz and the graph agree, the CPU agrees with TensorFlow's
    session, the npz decode is exact, the golden FID holds; the report
    names each check's oracles and leaves the converted npz behind."""
    tf = _tf()
    import json
    from tests.test_inception_eval import _build_tf_graphdef
    pb = tmp_path / "inception_synthetic.pb"
    pb.write_bytes(_build_tf_graphdef(
        _inception_npz_weights(2)).SerializeToString())
    data_dir = tmp_path / "data"
    polygons.write_npz_dataset(str(data_dir), n_train=16, n_test=16,
                               n_holdout=4)
    workdir = tmp_path / "work"
    feature_oracles, record_oracles = _tf_oracles(tf)
    rc = validate_real_assets.main(
        [f"--inception_pb={pb}", "--dataset=convex_polygons",
         f"--data_dir={data_dir}", f"--workdir={workdir}",
         "--num_examples=8", "--fid_samples=4", "--device=cpu"],
        feature_oracles=feature_oracles, record_oracles=record_oracles)
    report = json.loads((workdir / "report.json").read_text())
    assert rc == 0, report
    assert report["all_ok"] is True
    assert report["inception"]["oracles"] == ["graph", "cpu", "tensorflow"]
    assert report["inception"]["max_abs_pool_diff_npz_vs_graph"] == 0.0
    assert report["inception"]["max_abs_pool_diff_tensorflow"] < 5e-2
    assert report["dataset"]["decode_oracles"] == ["npz"]
    assert report["dataset"]["max_abs_decode_diff"] <= 1e-6
    assert report["dataset"]["train"]["checked"] == 8
    assert (report["golden_fid"]["fid_real_real"]
            < 0.25 * report["golden_fid"]["fid_real_noise"])
    assert (workdir / "inception_from_pb.npz").exists()


def test_kit_tfrecord_decode_parity_and_fid_skip(tmp_path, kit_env):
    """TFRecord shards: each record reread with its CRCs checked decodes by
    `tf_io` and by TensorFlow to what the pipeline's source yields; with no
    Inception source the golden FID reports SKIP, not a false PASS."""
    tf = _tf()
    import json
    from tests.helpers import write_tfds_fixture
    data_dir = tmp_path / "data"
    write_tfds_fixture(data_dir, tfds_name="cifar10", resolution=32,
                       split_shards=(("train", 24, 2), ("test", 12, 1)))
    workdir = tmp_path / "work"
    _, record_oracles = _tf_oracles(tf)
    rc = validate_real_assets.main(
        ["--dataset=cifar10", f"--data_dir={data_dir}",
         f"--workdir={workdir}", "--num_examples=12", "--device=cpu"],
        record_oracles=record_oracles)
    report = json.loads((workdir / "report.json").read_text())
    assert rc == 0, report
    assert report["all_ok"] is True
    assert report["dataset"]["decode_oracles"] == ["tensorflow", "tf_io"]
    assert report["dataset"]["max_abs_decode_diff"] <= 1e-6
    assert report["dataset"]["num_train"] == 24
    assert report["golden_fid"]["ok"] is None
    assert "skipped" in report["golden_fid"]


def test_kit_fails_a_record_that_decodes_otherwise(tmp_path, kit_env):
    """A control: an oracle that disagrees by one level fails the check."""
    import json
    from tests.helpers import write_tfds_fixture
    _tf()
    data_dir = tmp_path / "data"
    write_tfds_fixture(data_dir, tfds_name="cifar10", resolution=32,
                       split_shards=(("train", 4, 1), ("test", 4, 1)))

    def off_by_one(payload):
        image, label = validate_real_assets._tf_io_record(payload)
        return image ^ 1, label

    rc = validate_real_assets.main(
        ["--dataset=cifar10", f"--data_dir={data_dir}",
         f"--workdir={tmp_path / 'work'}", "--num_examples=4",
         "--device=cpu"], record_oracles={"off_by_one": off_by_one})
    report = json.loads((tmp_path / "work" / "report.json").read_text())
    assert rc == 1 and report["dataset"]["ok"] is False


def test_kit_requires_some_asset(tmp_path, capsys):
    with pytest.raises(SystemExit) as exit_info:
        validate_real_assets.main([f"--workdir={tmp_path / 'w'}"])
    assert exit_info.value.code != 0
    assert "Nothing to validate" in capsys.readouterr().err


CHILD = """
import sys
# A None entry makes `import name` raise and find_spec(name) say absent.
BLOCKED = ("tensorflow", "tensorboard", "jax", "optax", "compare_gan_tpu")
for name in BLOCKED:
    sys.modules[name] = None
import os
import numpy as np
from compare_gan_torch import polygons, summaries
from compare_gan_torch.tools import rotation_probe, tb_scalars
from compare_gan_torch.tools import validate_real_assets
work = sys.argv[1]
writer = summaries.SummaryWriter(work)
writer.scalar("loss/g", 0.5, 3)
writer.image_grid("fake_images", np.zeros((4, 4, 4, 1), np.float32), 3)
writer.close()
assert tb_scalars.main([f"--model_dir={work}", f"--out_dir={work}/csv"]) == 0
data = os.path.join(work, "data")
polygons.write_multiclass_npz_dataset(data, n_train=8, n_test=8,
                                      n_holdout=4)
os.environ["COMPARE_GAN_DATA_DIR"] = data
rotation_probe.main(["--datasets", "convex_polygons_multiclass",
                     "--n_train=8", "--n_test=8", "--steps=2",
                     "--device=cpu"])
assert validate_real_assets.main([
    "--dataset=convex_polygons_multiclass", f"--data_dir={data}",
    f"--workdir={work}/kit", "--num_examples=4", "--device=cpu"]) == 0
loaded = [m for m, v in sys.modules.items()
          if v is not None and m.split(".")[0] in BLOCKED]
assert not loaded, loaded
print("tools ran without", BLOCKED)
"""


def test_tools_run_without_jax_or_tensorflow(tmp_path):
    """In a process that cannot import JAX, optax, TensorFlow, TensorBoard
    or the JAX package: the port writes event files, tb_scalars reads
    them, the probe trains and the kit checks an npz dataset."""
    import subprocess
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path)],
                         cwd=repo, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert "tools ran without" in out.stdout
    assert (tmp_path / "csv" / "loss_g.csv").read_bytes() == \
        b"step,g\r\n3,0.5\r\n"

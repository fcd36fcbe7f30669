"""The port reads TensorFlow's files where TensorFlow, PIL and protobuf are
absent, as on the card's machine: a subprocess that cannot import
`tensorflow`, `PIL` or `google.protobuf` reads TensorFlow-written TFRecords
(JPEG and PNG) through the input pipeline, a TensorFlow-written GraphDef
through the Inception reader and a Saver checkpoint through the bundle
reader, and gets the values TensorFlow gives. And no module of the port
imports any of them, or JAX, anywhere in its source."""

import ast
import glob
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_fixtures")

CHILD = textwrap.dedent("""
    import importlib.abc
    import os
    import sys

    BLOCKED = ("tensorflow", "PIL", "google.protobuf")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.startswith(BLOCKED):
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    from compare_gan_torch import datasets
    from compare_gan_torch.metrics import inception_net
    from compare_gan_torch.tf_io import checkpoint_bundle

    work = sys.argv[1]
    want = np.load(os.path.join(work, "want.npz"))
    datasets.DATA_DIR = os.path.join(work, "data")
    ds = datasets.get_dataset("imagenet_64")
    src = ds._get_source()
    for i in range(src.num_examples("validation")):
        image, label, name = src.get("validation", i, 0)
        assert np.array_equal(image, want[f"image{i}"]), i
        assert label == int(want[f"label{i}"]), i
    batch = next(ds.train_input_fn(batch_size=4))
    assert batch["images"].shape == (4, 64, 64, 3)
    assert np.isfinite(batch["images"]).all()

    graph = inception_net.read_frozen_graph(os.path.join(work, "g.pb"))
    assert sorted(graph) == ["w/conv", "w/fc"], sorted(graph)
    for k, v in graph.items():
        assert np.array_equal(v, want["graph/" + k]), k

    reader = checkpoint_bundle.CheckpointReader(
        checkpoint_bundle.resolve_checkpoint(os.path.join(work, "ckpt")))
    for k in reader.variable_to_shape_map():
        assert np.array_equal(reader.get_tensor(k), want["ckpt/" + k]), k

    loaded = [m for m in sys.modules if m.startswith(BLOCKED)]
    assert not loaded, loaded
    print("read without tensorflow")
""")


def test_tensorflow_files_read_without_tensorflow(tmp_path):
    tf = pytest.importorskip("tensorflow")
    names = sorted(n for n in os.listdir(FIXTURES)
                   if n.endswith((".jpg", ".png")))
    want = {}
    data_dir = tmp_path / "data" / "imagenet2012"
    data_dir.mkdir(parents=True)
    records = {"validation": [], "train": []}
    for i, name in enumerate(names):
        with open(os.path.join(FIXTURES, name), "rb") as f:
            encoded = f.read()
        ex = tf.train.Example(features=tf.train.Features(feature={
            "image": tf.train.Feature(
                bytes_list=tf.train.BytesList(value=[encoded])),
            "label": tf.train.Feature(
                int64_list=tf.train.Int64List(value=[i * 61])),
            "file_name": tf.train.Feature(bytes_list=tf.train.BytesList(
                value=[name.encode()]))})).SerializeToString()
        image = tf.io.decode_image(encoded).numpy()
        # Every fixture in the split get() is held on; the RGB ones in the
        # split the ImageNet pipeline batches (its images are all RGB).
        records["validation"].append(ex)
        if image.shape[2] == 3:
            records["train"].append(ex)
        # TFRecordSource's f32 conversion of TF's decode.
        want[f"image{i}"] = image.astype(np.float32) * np.float32(1 / 255)
        want[f"label{i}"] = i * 61
    for split, payloads in records.items():
        with tf.io.TFRecordWriter(str(
                data_dir / f"imagenet2012-{split}.tfrecord-00000-of-00001"
        )) as w:
            for payload in payloads:
                w.write(payload)

    graph = tf.Graph()
    rng = np.random.RandomState(0)
    with graph.as_default():
        for name, value in (("w/conv", rng.randn(3, 3, 2, 4)),
                            ("w/fc", rng.randn(5).astype(np.float16)),
                            ("w/eps", np.float32(1e-3)),
                            ("w/axis", np.int32([1, 2]))):
            tf.constant(value, name=name)
            if name in ("w/conv", "w/fc"):
                want["graph/" + name] = value
    (tmp_path / "g.pb").write_bytes(graph.as_graph_def().SerializeToString())

    graph = tf.Graph()
    with graph.as_default():
        for name, value in (("generator/k", rng.randn(4, 3).astype(
                np.float32)), ("global_step", np.int64(5))):
            tf.compat.v1.get_variable(name, initializer=value)
            want["ckpt/" + name] = value
        saver = tf.compat.v1.train.Saver()
        with tf.compat.v1.Session(graph=graph) as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            saver.save(sess, str(tmp_path / "ckpt" / "model.ckpt-5"))
    np.savez(tmp_path / "want.npz", **want)

    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert "read without tensorflow" in out.stdout


# Every module of the port and chip_smoke.py, scanned for imports anywhere
# in the file (inside functions too): the card's machine has none of these.
FORBIDDEN = ("tensorflow", "PIL", "google.protobuf", "jax",
             "compare_gan_tpu")
PORT_FILES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "compare_gan_torch", "**", "*.py"),
              recursive=True)
    if "_build" not in os.path.relpath(p, REPO).split(os.sep)
) + ["chip_smoke.py"]


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_module_imports_no_tensorflow_pil_protobuf_or_jax(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [name for name in _imports(tree)
           if any(name == m or name.startswith(m + ".") for m in FORBIDDEN)]
    assert bad == []

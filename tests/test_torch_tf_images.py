"""The port reads TFDS TFRecords and decodes their images without TensorFlow
(compare_gan_torch/tf_io, csrc/image_decode.cc), pixel for pixel as the JAX
package does through TensorFlow.

* Every committed fixture (tests/torch_fixtures, written by
  tools/make_tf_format_fixtures.py) decodes bitwise to its golden, the
  `tf.io.decode_image` output stored beside it; with TensorFlow present the
  goldens are re-derived, so a drifted fixture fails. Bitwise holds for
  every JPEG case too (baseline 4:2:0 / 4:4:4, progressive, grayscale,
  4:2:2, restart intervals): the C++ decoder follows libjpeg's fast integer
  IDCT, fancy upsampling and YCbCr tables, so no JPEG case needs the
  INTEGER_FAST-vs-ACCURATE allowance (4 levels max, 0.5 mean).
* TFRecordSource.get equals the JAX package's on TF-written records of all
  the fixtures, and the sidecar labels (hard and soft) equal the JAX
  package's.
* Records the port writes read back in TensorFlow with their checksums.
"""

import glob
import io
import os

import numpy as np
import pytest

from compare_gan_torch import config as tgin
from compare_gan_torch import datasets, native
from compare_gan_torch.tf_io import image_codec, protobuf, tfrecord

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_fixtures")
IMAGES = sorted(os.path.basename(p) for p in
                glob.glob(os.path.join(FIXTURES, "*.jpg"))
                + glob.glob(os.path.join(FIXTURES, "*.png")))


def _fixture(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    return data, np.load(os.path.join(FIXTURES,
                                      os.path.splitext(name)[0] + ".npy"))


def test_the_fixtures_cover_the_formats():
    assert len(IMAGES) == 16
    kinds = {image_codec.image_format(_fixture(n)[0]) for n in IMAGES}
    assert kinds == {"jpeg", "png"}


@pytest.mark.parametrize("name", IMAGES)
def test_decode_is_bitwise_the_tensorflow_golden(name):
    data, golden = _fixture(name)
    got = image_codec.decode_image(data)
    assert got.dtype == golden.dtype == np.uint8
    assert got.shape == golden.shape
    np.testing.assert_array_equal(got, golden)


def test_png_python_unfilter_equals_the_native_one(monkeypatch):
    """The PNG scanline loop of the native library against the Python
    fallback (every fixture: all five filter types run in the interlaced
    ones)."""
    pngs = [n for n in IMAGES if n.endswith(".png")]
    native_out = [image_codec.decode_image(_fixture(n)[0]) for n in pngs]
    monkeypatch.setattr(native, "available", lambda: False)
    for name, want in zip(pngs, native_out):
        np.testing.assert_array_equal(
            image_codec.decode_image(_fixture(name)[0]), want, err_msg=name)


@pytest.mark.parametrize("name", IMAGES)
def test_golden_is_what_tensorflow_decodes(name):
    tf = pytest.importorskip("tensorflow")
    data, golden = _fixture(name)
    np.testing.assert_array_equal(tf.io.decode_image(data).numpy(), golden)


def test_jpeg_decode_matches_tensorflow_on_fresh_encodings():
    """JPEGs encoded here (so not only the committed bytes): high-contrast
    blocks at quality 100 drive the IDCT's largest coefficients; images 2
    and 5 px wide take libjpeg's replicating upsampler (chroma 1 or 3
    samples wide) and its fancy one at the narrowest width."""
    tf = pytest.importorskip("tensorflow")
    rng = np.random.RandomState(3)
    blocks = (rng.randint(0, 2, (6, 7)) * 255).astype(np.uint8)
    blocks = np.repeat(np.repeat(blocks, 8, 0), 8, 1)[:, :, None]
    cases = [np.repeat(blocks, 3, 2),
             rng.randint(0, 256, (21, 34, 3)).astype(np.uint8), blocks,
             rng.randint(0, 256, (3, 2, 3)).astype(np.uint8),
             rng.randint(0, 256, (9, 5, 3)).astype(np.uint8),
             rng.randint(0, 256, (7, 6, 3)).astype(np.uint8)]
    for image in cases:
        for kwargs in ({"quality": 100}, {"quality": 60,
                                          "progressive": True},
                       {"quality": 95, "chroma_downsampling": False}):
            data = tf.io.encode_jpeg(image, **kwargs).numpy()
            np.testing.assert_array_equal(image_codec.decode_image(data),
                                          tf.io.decode_image(data).numpy())



def test_unsupported_images_are_refused_with_their_reason():
    data, _ = _fixture("jpeg_420_q90.jpg")
    sof = data.index(b"\xff\xc0")
    cases = {
        "arithmetic": data[:sof] + b"\xff\xc9" + data[sof + 2:],
        "lossless": data[:sof] + b"\xff\xc3" + data[sof + 2:],
        "12-bit": data[:sof + 4] + b"\x0c" + data[sof + 5:],
        "gif": b"GIF89a" + bytes(20),
        "bmp": b"BM" + bytes(30),
        "truncated": b"\xff\xd8\xff" + bytes(8),
    }
    for reason, bad in cases.items():
        with pytest.raises(ValueError, match=reason):
            image_codec.decode_image(bad)


def test_cmyk_jpeg_is_refused():
    Image = pytest.importorskip("PIL.Image")
    f = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 4), np.uint8), "CMYK").save(f, "JPEG")
    with pytest.raises(ValueError, match="4-component"):
        image_codec.decode_image(f.getvalue())


def test_example_parsing_reads_packed_and_unpacked_fields():
    """TensorFlow writes packed lists; other writers may not. Both parse,
    negative int64 included, and unknown fields are skipped."""
    tf = pytest.importorskip("tensorflow")
    ex = tf.train.Example(features=tf.train.Features(feature={
        "image": tf.train.Feature(bytes_list=tf.train.BytesList(
            value=[b"abc", b""])),
        "label": tf.train.Feature(int64_list=tf.train.Int64List(
            value=[-3, 2 ** 40, 0])),
        "logits": tf.train.Feature(float_list=tf.train.FloatList(
            value=[1.5, -0.25])),
        "empty": tf.train.Feature()}))
    feats = protobuf.parse_example(ex.SerializeToString())
    assert feats["image"].bytes_list == [b"abc", b""]
    assert feats["label"].int64_list == [-3, 2 ** 40, 0]
    np.testing.assert_array_equal(feats["logits"].float_list,
                                  np.float32([1.5, -0.25]))
    assert not feats["empty"].bytes_list and not feats["empty"].int64_list
    # Unpacked (one field per value) and an unknown field 9.
    unpacked = protobuf.field_bytes(3, b"".join(
        protobuf.field_varint(1, v) for v in (7, -1)))
    floats = protobuf.field_bytes(2, b"".join(
        protobuf.field_fixed32(1, int(np.float32(v).view(np.uint32)))
        for v in (0.5, 2.0)))
    entry = lambda k, v: protobuf.field_bytes(  # noqa: E731
        1, protobuf.field_bytes(1, k) + protobuf.field_bytes(2, v))
    raw = protobuf.field_bytes(1, entry(b"a", unpacked) + entry(b"b", floats)
                               ) + protobuf.field_varint(9, 5)
    feats = protobuf.parse_example(raw)
    assert feats["a"].int64_list == [7, -1]
    np.testing.assert_array_equal(feats["b"].float_list, np.float32([.5, 2]))
    # The port's encoder round-trips through TensorFlow's parser.
    mine = protobuf.encode_example({"image": b"xy", "label": -5,
                                    "soft": np.float32([0.25, 4.0])})
    back = tf.train.Example.FromString(mine).features.feature
    assert back["image"].bytes_list.value == [b"xy"]
    assert list(back["label"].int64_list.value) == [-5]
    assert list(back["soft"].float_list.value) == [0.25, 4.0]


def _write_all_fixtures(directory, tf):
    """A TFDS-layout train split of every fixture, written by TensorFlow:
    `image` + `label` + `file_name`, and one record with the
    `image/encoded` + `image/class/label` keys."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "ds-train.tfrecord-00000-of-00001")
    with tf.io.TFRecordWriter(path) as w:
        for i, name in enumerate(IMAGES):
            data, _ = _fixture(name)
            image_key, label_key = (("image/encoded", "image/class/label")
                                    if i == 3 else ("image", "label"))
            ex = tf.train.Example(features=tf.train.Features(feature={
                image_key: tf.train.Feature(
                    bytes_list=tf.train.BytesList(value=[data])),
                label_key: tf.train.Feature(
                    int64_list=tf.train.Int64List(value=[i * 37 - 100])),
                "file_name": tf.train.Feature(bytes_list=tf.train.BytesList(
                    value=[name.encode()]))}))
            w.write(ex.SerializeToString())
    return path


def test_tfrecord_source_equals_the_jax_package(tmp_path):
    tf = pytest.importorskip("tensorflow")
    from compare_gan_tpu import datasets as jdatasets
    _write_all_fixtures(str(tmp_path), tf)
    mine = datasets.TFRecordSource(str(tmp_path))
    ref = jdatasets.TFRecordSource(str(tmp_path))
    assert mine.num_examples("train") == ref.num_examples("train") == 16
    for i in range(16):
        got, want = mine.get("train", i, 0), ref.get("train", i, 0)
        assert got[0].dtype == want[0].dtype == np.float32
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:] == (i * 37 - 100, IMAGES[i])


def test_a_refused_image_names_its_record(tmp_path):
    path = os.path.join(str(tmp_path), "x-train.tfrecord-00000-of-00001")
    tfrecord.write_tfrecords(path, [
        protobuf.encode_example({"image": _fixture(IMAGES[0])[0],
                                 "label": 1}),
        protobuf.encode_example({"image": b"GIF89a" + bytes(30),
                                 "label": 2})])
    src = datasets.TFRecordSource(str(tmp_path))
    src.get("train", 0, 0)
    with pytest.raises(ValueError, match=r"record 1 of split 'train' .*"
                       r"x-train.tfrecord-00000-of-00001 at byte \d+.*gif"):
        src.get("train", 1, 0)


def test_records_the_port_writes_read_back_in_tensorflow(tmp_path):
    tf = pytest.importorskip("tensorflow")
    payloads = [protobuf.encode_example({"image": _fixture(n)[0],
                                         "label": i})
                for i, n in enumerate(IMAGES)]
    path = str(tmp_path / "mine.tfrecord")
    assert tfrecord.write_tfrecords(path, payloads) == len(payloads)
    # TFRecordDataset checks both CRCs of every record.
    got = [r.numpy() for r in tf.data.TFRecordDataset(path)]
    assert got == payloads
    for i, raw in enumerate(got):
        ex = tf.train.Example.FromString(raw).features.feature
        assert ex["label"].int64_list.value[0] == i
    # And the CRC32C itself, native and the Python loop: the standard's
    # check value, and TF's mask.
    assert tfrecord.crc32c(b"123456789") == 0xE3069283
    assert tfrecord._py_crc32c(b"123456789") == 0xE3069283
    assert native.crc32c(b"3456789", native.crc32c(b"12")) == 0xE3069283
    assert tfrecord.unmask(tfrecord.mask(0xDEADBEEF)) == 0xDEADBEEF


@pytest.fixture
def _data_dirs(tmp_path, monkeypatch):
    """One TFDS fixture (TF-written, PNG) seen by both packages."""
    from compare_gan_tpu import datasets as jdatasets
    from tests.helpers import write_tfds_fixture
    pytest.importorskip("tensorflow")
    fixture = write_tfds_fixture(tmp_path)
    for mod in (datasets, jdatasets):
        monkeypatch.setattr(mod, "DATA_DIR", str(tmp_path))
        mod.set_fake_dataset(False)
    tgin.clear_config()
    yield tmp_path, fixture, jdatasets
    tgin.clear_config()


@pytest.mark.parametrize("soft", [False, True])
def test_sidecar_labels_equal_the_jax_package(_data_dirs, soft):
    from compare_gan_tpu import config as jgin
    from tests.helpers import write_label_sidecar
    tmp_path, fixture, jdatasets = _data_dirs
    names, labels, _ = fixture["train"]
    rng = np.random.RandomState(5)
    new = (rng.randn(len(names), 10).astype(np.float32) if soft
           else [(int(x) + 3) % 10 for x in labels])
    sidecar = tmp_path / "sidecar"
    sidecar.mkdir()
    write_label_sidecar(sidecar / "labels-train.tfrecord", names, new)
    binding = (f"replace_labels.file_pattern = "
               f"'{sidecar}/labels-{{split}}.tfrecord'")
    tgin.parse_config(binding)
    jgin.parse_config(binding)
    got = datasets.get_dataset("cifar10")._sidecar_labels("train")
    want = jdatasets.get_dataset("cifar10")._sidecar_labels("train")
    assert got[0] == want[0] == names
    assert len(got[1]) == len(want[1]) == len(names)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
        assert np.asarray(g).dtype == np.asarray(w).dtype


def test_area_resize_without_the_native_library_matches_it(monkeypatch):
    """The numpy area resize (the fallback that replaced PIL) against the
    native kernel: the same box weights summed in another order."""
    rng = np.random.RandomState(0)
    image = rng.rand(37, 23, 3).astype(np.float32)
    for size in ((16, 16), (50, 31), (37, 23), (5, 40)):
        want = native.resize_area(image, size)
        monkeypatch.setattr(native, "available", lambda: False)
        got = datasets._resize_area(image, size)
        monkeypatch.undo()
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)

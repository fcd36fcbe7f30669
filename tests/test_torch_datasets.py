"""The port's input pipeline (compare_gan_torch.datasets, polygons and the
native record reader) against the JAX package's: for the same dataset name,
seed and batch size the batches are bitwise equal."""

import os

import numpy as np
import pytest

from tests import torch_helpers  # noqa: F401 (one torch thread)

from compare_gan_tpu import datasets as jdatasets
from compare_gan_tpu import native as jnative
from compare_gan_tpu import polygons as jpolygons
from compare_gan_torch import config as tgin
from compare_gan_torch import datasets, native, polygons


@pytest.fixture(autouse=True)
def _setup():
    # Load the JAX package's native library before its pipeline threads
    # do: its lazy loader is not thread-safe, and a thread that finds it
    # half loaded converts uint8 to float on the numpy path (x / 255),
    # one ulp off the native x * (1 / 255) for some values.
    jnative.available()
    tgin.clear_config()
    yield
    for module in (datasets, jdatasets):
        module.set_fake_dataset(False)
    tgin.clear_config()


def _assert_same_batches(name, seed, batch_size, count, eval_batches=0):
    port = datasets.get_dataset(name, seed=seed)
    ref = jdatasets.get_dataset(name, seed=seed)
    assert (port.name, port.num_classes, port.image_shape) == (
        ref.name, ref.num_classes, ref.image_shape)
    streams = [(port.train_input_fn(batch_size),
                ref.train_input_fn(batch_size), count)]
    if eval_batches:
        streams.append((port.eval_input_fn(batch_size),
                        ref.eval_input_fn(batch_size), eval_batches))
    for got_it, want_it, n in streams:
        for _ in range(n):
            got, want = next(got_it), next(want_it)
            assert set(got) == set(want) == {"images", "labels"}
            for k in got:
                assert got[k].dtype == want[k].dtype, k
                assert got[k].shape == want[k].shape, k
                assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("name", ["imagenet_128", "cifar10", "celeb_a",
                                  "lsun-bedroom",
                                  "random_class_imagenet_128"])
def test_fake_batches_equal_the_jax_package(name):
    """`--data_fake_dataset`: ImageNet-128 (distorted crop + bilinear
    resize through the native library), and datasets with other
    transforms and label maps."""
    for module in (datasets, jdatasets):
        module.set_fake_dataset(True)
    _assert_same_batches(name, seed=547, batch_size=4, count=2)


@pytest.mark.parametrize("writer, sub", [
    ("write_multiclass_npz_dataset", "convex_polygons_multiclass"),
    ("write_npz_dataset", "convex_polygons"),
    ("write_oriented_npz_dataset", "convex_polygons_oriented"),
    ("write_partial_npz_dataset", "convex_polygons_partial"),
    ("write_partial_oriented_npz_dataset",
     "convex_polygons_partial_oriented")])
def test_polygon_set_equals_the_jax_package(writer, sub, tmp_path,
                                            monkeypatch):
    """A small polygon set of each kind the convergence proofs train on,
    written by both packages' writers, is the same data (images, labels,
    and the partial sets' unlabeled rows, -1), and both pipelines read it
    into the same train and eval batches."""
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    kw = dict(n_train=48, n_test=16, n_holdout=8, seed=3)
    getattr(polygons, writer)(str(port_dir), **kw)
    getattr(jpolygons, writer)(str(ref_dir), **kw)
    for split in ("train", "test", "holdout"):
        with np.load(port_dir / sub / f"{split}.npz") as a, \
                np.load(ref_dir / sub / f"{split}.npz") as b:
            for k in ("images", "labels"):
                assert a[k].dtype == b[k].dtype, (split, k)
                assert np.array_equal(a[k], b[k]), (split, k)
            unlabeled = a["labels"] == -1
            if "partial" in sub and split == "train":
                assert 0 < unlabeled.sum() < len(unlabeled)
            else:
                assert not unlabeled.any()
    monkeypatch.setattr(datasets, "DATA_DIR", str(port_dir))
    monkeypatch.setattr(jdatasets, "DATA_DIR", str(ref_dir))
    _assert_same_batches(sub, seed=5, batch_size=8, count=3, eval_batches=2)


@pytest.mark.parametrize("generate", ["generate_multiclass_dataset",
                                      "generate_oriented_dataset",
                                      "generate_dataset"])
def test_worker_pool_rasterizes_what_the_serial_path_does(generate):
    """`n_workers=2` rasterizes in worker threads: the images and labels
    are bitwise those of the port's and the JAX package's serial paths."""
    kw = dict(n_instances=24, raster_dim=16, subpixel_res=4, seed=7)
    pooled = getattr(polygons, generate)(n_workers=2, **kw)
    serial = getattr(polygons, generate)(n_workers=0, **kw)
    reference = getattr(jpolygons, generate)(**kw)  # Serial there.
    for got, want in ((pooled, serial), (pooled, reference)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_gin_selects_the_dataset_and_its_transform():
    """`dataset.name` and `train_imagenet_transform.crop_method` bind in the
    port's own registry, as in the JAX package's."""
    from compare_gan_tpu import config as jgin
    text = ("dataset.name = 'imagenet_128'\n"
            "train_imagenet_transform.crop_method = 'middle'\n")
    tgin.parse_config(text)
    jgin.clear_config()
    jgin.parse_config(text)
    try:
        for module in (datasets, jdatasets):
            module.set_fake_dataset(True)
        port, ref = datasets.get_dataset(seed=9), jdatasets.get_dataset(
            seed=9)
        got, want = next(port.train_input_fn(2)), next(ref.train_input_fn(2))
        assert np.array_equal(got["images"], want["images"])
        assert "train_imagenet_transform" in tgin.operative_config_str()
    finally:
        jgin.clear_config()


def test_native_library_builds_into_the_build_directory():
    """g++ builds csrc/dataio.cc at first use into compare_gan_torch/_build,
    never beside the source; its resize equals the numpy fallback's
    bilinear resize to float rounding."""
    if not native.available():
        pytest.skip("no g++ to build the native data-IO library")
    path = native._library_path()
    assert os.path.dirname(path).endswith(os.path.join("compare_gan_torch",
                                                       "_build"))
    assert os.path.exists(path)
    image = np.random.RandomState(0).rand(37, 29, 3).astype(np.float32)
    np.testing.assert_allclose(native.resize_bilinear(image, (16, 16)),
                               datasets._resize_bilinear_np(image, (16, 16)),
                               rtol=1e-6, atol=1e-6)

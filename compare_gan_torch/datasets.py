"""Datasets of the port: its own copy of the JAX package's host-side input
pipeline (compare_gan_tpu/datasets.py), numpy only.

Batches are numpy dicts ({"images": f32 [B,H,W,C] in [0, 1], "labels":
int32 [B]}) until the trainer moves them to its device. For the same
dataset name, seed and batch size they are bitwise equal to the JAX
package's (tests/test_torch_datasets.py).

* Deterministic seeding: effective seed = seed + host_id (reference
  datasets.py:147-172). The hosts are those of the data-parallel process
  group (`parallel.mesh_utils.process_topology`; one host, (1, 0),
  outside it) unless a dataset is built with other values.
* Fake in-memory dataset behind `set_fake_dataset(True)` for tests
  (reference datasets.py:52-54,136-145; `--data_fake_dataset`).
* Real data from either `.npz` shards or TFRecord files under
  `$COMPARE_GAN_DATA_DIR/<tfds_name>/`; TFRecords use the standard TFDS
  on-disk layout, so data prepared for the reference loads unchanged.
* Label replacement / soft labels from sidecar files (reference
  datasets.py:174-223,587-617).
* z and sampled labels are not drawn here: the trainer draws them on the
  device from the per-step RNG stream (ops/rng.py).
* Records are parsed and their PNG/JPEG images decoded without TensorFlow
  (`tf_io`), pixel for pixel as `tf.io.decode_image`.
* Record IO and the crop/resize transforms use the port's native library
  (native.py, csrc/dataio.cc) when g++ can build it, numpy otherwise; JPEG
  decoding needs that library (csrc/image_decode.cc).

Registry names match the reference's DATASETS (datasets.py:620-640), plus
`celeb_a_hq_128` (referenced by sndcgan_celebahq128.gin but missing from
the reference registry).
"""

from __future__ import annotations

import functools
import glob
import os
import queue
import tempfile
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

from compare_gan_torch import config as gin
from compare_gan_torch import native
from compare_gan_torch.parallel import mesh_utils
from compare_gan_torch.tf_io import image_codec, protobuf

# Process-level options (reference: absl flags, datasets.py:46-63).
# No shuffle-buffer knob: shuffling is a full per-epoch permutation
# (deterministic, stronger than the reference's windowed buffer).
FAKE_DATASET = False  # --data_fake_dataset
DATA_DIR = os.environ.get(
    "COMPARE_GAN_DATA_DIR", os.path.join(tempfile.gettempdir(),
                                         "compare_gan_data"))


def set_fake_dataset(value: bool) -> None:
    global FAKE_DATASET
    FAKE_DATASET = bool(value)


def _u8_to_f32(image: np.ndarray) -> np.ndarray:
    """uint8 -> float32 [0,1] via the native kernel when built (the
    per-example decode post-processing fast path)."""
    if native.available():
        return native.u8_to_f32(image).reshape(image.shape)
    return image.astype(np.float32) / 255.0


# ---------------------------------------------------------------------------
# Record sources
# ---------------------------------------------------------------------------


class FakeSource:
    """Deterministic random records (reference datasets.py:136-145).

    Per-index determinism: record i is a pure function of (seed, split, i),
    so shuffling order does not change pixel content.
    """

    def __init__(self, shape, num_classes, num_examples=128):
        self._shape = tuple(shape)
        self._num_classes = num_classes
        self._num_examples = num_examples

    def num_examples(self, split):
        return self._num_examples

    def get(self, split, index, seed):
        # Stable key: Python's str hash is salted per process
        # (PYTHONHASHSEED), which would break the bitwise-identical-
        # across-restarts contract for fake-data runs.
        import hashlib
        key = int.from_bytes(
            hashlib.sha256(f"{split}/{seed}".encode()).digest()[:8], "little")
        # Fold the index into the KEY, not the counter: counter=index
        # starts record i at counter block i, so consecutive records
        # would read overlapping blocks of one stream (near-duplicate
        # images shifted by one element).
        key = (key ^ (index * 0x9E3779B97F4A7C15)) % (2 ** 63)
        rng = np.random.Generator(np.random.Philox(key=key))
        image = rng.random(self._shape, dtype=np.float32)
        label = int(rng.integers(0, self._num_classes or 1))
        return image, label, None


class NpzSource:
    """In-memory arrays from `<data_dir>/<name>/<split>.npz` with keys
    `images` (uint8 [N,H,W,C]) and `labels` (int [N])."""

    def __init__(self, directory):
        self._dir = directory
        self._cache = {}

    def _load(self, split):
        if split not in self._cache:
            with np.load(os.path.join(self._dir, f"{split}.npz")) as data:
                self._cache[split] = (np.asarray(data["images"]),
                                      np.asarray(data["labels"]))
        return self._cache[split]

    def num_examples(self, split):
        return len(self._load(split)[0])

    def get(self, split, index, seed):
        images, labels = self._load(split)
        image = images[index]
        if image.dtype == np.uint8:
            image = _u8_to_f32(image)
        return image, int(labels[index]), None


def _py_iter_tfrecords(path, start=0, read_payloads=True):
    """(offset, payload) pairs of one TFRecord file from byte `start`, in
    order — the SINGLE pure-Python reader of the 12-byte TFRecord
    framing (u64 length, 4B length-crc, payload, 4B payload-crc). Every
    Python-fallback reader below goes through here; the only other reader
    is the native C++ one (dataio.cc), and tf_io.tfrecord writes it.
    read_payloads=False yields (offset, None) and SEEKS past each payload
    — index construction over multi-GB shards must not read (and
    allocate) every image byte just to learn the offsets."""
    import struct
    with open(path, "rb") as f:
        f.seek(start)
        while True:
            pos = f.tell()
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if read_payloads:
                payload = f.read(length)
                f.seek(4, os.SEEK_CUR)  # payload crc
            else:
                payload = None
                f.seek(length + 4, os.SEEK_CUR)
            yield pos, payload


def _read_tfrecord_payloads(path):
    """All record payloads of one TFRecord file, in order (native C++
    index + read when available, pure-Python framing otherwise)."""
    if native.available():
        for off in native.index_tfrecords(path):
            yield native.read_record(path, off)
        return
    for _, payload in _py_iter_tfrecords(path):
        yield payload


@gin.configurable("replace_labels")
def _replace_labels_pattern(file_pattern=None):
    """Gin surface of the reference's label replacement
    (`replace_labels.file_pattern`, reference datasets.py:174-199): a
    glob with a `{split}` placeholder naming sidecar TFRecords whose
    Examples carry `file_name` + `label` (int64 hard label, or a float
    list of logits soft-maxed into a soft label)."""
    return file_pattern


class TFRecordSource:
    """TFDS-layout TFRecord shards: `<data_dir>/<name>/<split>*.tfrecord*`.

    Each record is a serialized `tf.train.Example` with an encoded `image`
    (or `image/encoded`), a `label` (or `image/class/label`) and, in TFDS
    data, a `file_name` — the layout `tfds build` produces, so data prepared
    for the reference loads unchanged. The port parses the records with its
    own protobuf reader and decodes PNG and JPEG as `tf.io.decode_image`
    does (`tf_io`), without TensorFlow.
    """

    def __init__(self, directory):
        self._dir = directory
        self._index = {}

    def _files(self, split):
        pats = [os.path.join(self._dir, f"{split}*.tfrecord*"),
                os.path.join(self._dir, f"*-{split}.tfrecord-*")]
        files = sorted(set(sum((glob.glob(p) for p in pats), [])))
        if not files:
            raise FileNotFoundError(
                f"No TFRecord shards for split '{split}' in {self._dir}.")
        return files

    def _ensure_index(self, split):
        """Build an offset index so `get(index)` is random-access, with
        the native C++ indexer when it is built, else the Python loop."""
        if split in self._index:
            return
        offsets = []
        if native.available():
            for path in self._files(split):
                offsets.extend((path, off)
                               for off in native.index_tfrecords(path))
        else:
            for path in self._files(split):
                offsets.extend(
                    (path, pos) for pos, _ in
                    _py_iter_tfrecords(path, read_payloads=False))
        self._index[split] = offsets

    def num_examples(self, split):
        self._ensure_index(split)
        return len(self._index[split])

    def get(self, split, index, seed):
        self._ensure_index(split)
        path, pos = self._index[split][index]
        if native.available():
            payload = native.read_record(path, pos)
        else:
            payload = next(_py_iter_tfrecords(path, start=pos))[1]
        feats = protobuf.parse_example(payload)
        if "image" in feats and feats["image"].bytes_list:
            encoded = feats["image"].bytes_list[0]
        elif "image/encoded" in feats:
            encoded = feats["image/encoded"].bytes_list[0]
        else:
            raise ValueError(f"Record in {path} lacks an image feature.")
        try:
            image = image_codec.decode_image(encoded)
        except ValueError as e:
            raise ValueError(f"Cannot decode the image of record {index} of "
                             f"split '{split}' ({path} at byte {pos}): "
                             f"{e}") from e
        label = 0
        for key in ("label", "image/class/label"):
            if key in feats and feats[key].int64_list:
                label = int(feats[key].int64_list[0])
                break
        file_name = None
        if "file_name" in feats and feats["file_name"].bytes_list:
            file_name = feats["file_name"].bytes_list[0].decode()
        # decode_image returns uint8 as TensorFlow does: 16-bit PNGs keep
        # their high byte, never a value wrapped modulo 256.
        return _u8_to_f32(image), label, file_name


# ---------------------------------------------------------------------------
# Transforms (reference datasets.py:348-533)
# ---------------------------------------------------------------------------


def _box_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] float64 weights of a box filter: output cell i covers
    [i, i + 1) * src / dst of the input, each input cell weighted by its
    overlap, each row normalized (the native kernel's box_resize)."""
    scale = src / dst
    lo = np.arange(dst) * scale
    hi = (np.arange(dst) + 1) * scale
    cells = np.arange(src)
    overlap = np.clip(np.minimum(cells[None, :] + 1, hi[:, None])
                      - np.maximum(cells[None, :], lo[:, None]), 0, None)
    return overlap / overlap.sum(axis=1, keepdims=True)


def _resize_area(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Area (box) resize of an f32 HWC image on the host: each output pixel
    is the overlap-weighted mean of the input pixels it covers (matches
    tf.image.resize area semantics closely enough for data prep; exactness
    is not part of the training contract). The native C++ kernel when it is
    built (native.py), else the same weights as two numpy products."""
    if native.available():
        return native.resize_area(np.asarray(image, np.float32), size)
    img = np.asarray(image, np.float64)
    wy = _box_weights(img.shape[0], size[0])
    wx = _box_weights(img.shape[1], size[1])
    out = np.einsum("yh,hwc,xw->yxc", wy, img, wx, optimize=True)
    return out.astype(np.float32)


def _resize_bilinear_np(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """TF1 `tf.image.resize_images` default bilinear on host: legacy scaling
    src = dst_idx * (in/out), align_corners=False (reference
    datasets.py:474-476). Pure-NumPy fallback for the native kernel."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    oh, ow = size
    fy = np.arange(oh, dtype=np.float32) * (np.float32(h) / np.float32(oh))
    fx = np.arange(ow, dtype=np.float32) * (np.float32(w) / np.float32(ow))
    y0 = np.minimum(fy.astype(np.int64), h - 1)
    x0 = np.minimum(fx.astype(np.int64), w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (fy - y0).astype(np.float32)[:, None, None]
    wx = (fx - x0).astype(np.float32)[None, :, None]
    top = img[y0][:, x0] + (img[y0][:, x1] - img[y0][:, x0]) * wx
    bot = img[y1][:, x0] + (img[y1][:, x1] - img[y1][:, x0]) * wx
    return top + (bot - top) * wy


@gin.configurable("image_resize")
def _resize(image, size, method="bilinear", crop=None):
    """Post-crop resize. The reference's `tf.image.resize_images` default is
    bilinear (datasets.py:474-476), so that's the default here; bind
    `image_resize.method = "area"` to opt into the box-filter path (better
    antialiasing for large downscales, but diverges from reference pixels).

    `crop=(top, left, h, w)` fuses the crop into the native resize kernel
    (reads the source in place, no intermediate copy)."""
    if crop is not None:
        top, left, ch, cw = crop
        if native.available():
            if method == "bilinear":
                return native.crop_resize_bilinear(
                    np.asarray(image, np.float32), top, left, ch, cw, size)
            if method == "area":
                return native.crop_resize(
                    np.asarray(image, np.float32), top, left, ch, cw, size)
        image = image[top:top + ch, left:left + cw]
    if image.shape[0] == size[0] and image.shape[1] == size[1]:
        return np.asarray(image, np.float32)
    if method == "bilinear":
        if native.available():
            return native.resize_bilinear(np.asarray(image, np.float32), size)
        return _resize_bilinear_np(image, size)
    if method == "area":
        return _resize_area(image, size)
    raise ValueError(f"Unsupported resize method: {method}")


def _crop_or_pad(image: np.ndarray, th: int, tw: int) -> np.ndarray:
    """tf.image.resize_image_with_crop_or_pad (reference
    datasets.py:390-392,472-475): center-crop dimensions that are larger
    than the target, zero-pad (centered, extra row/col at bottom/right)
    dimensions that are smaller."""
    h, w = image.shape[:2]
    top, left = max(0, (h - th) // 2), max(0, (w - tw) // 2)
    image = image[top:top + th, left:left + tw]
    h, w = image.shape[:2]
    if h < th or w < tw:
        pt, pl = (th - h) // 2, (tw - w) // 2
        image = np.pad(image, ((pt, th - h - pt), (pl, tw - w - pl), (0, 0)))
    return image


def transform_none(image, label, seed, rng):
    return image, label


def transform_celeba(image, label, seed, rng, size=64):
    """crop-or-pad to 160x160 then bilinear resize; constant label 0
    (reference CelebaDataset._parse_fn, datasets.py:387-396)."""
    image = _crop_or_pad(image, 160, 160)
    return _resize(image, (size, size)), 0


def transform_crop_or_pad(image, label, seed, rng, size):
    """Center crop-or-pad, no resize; constant label 0 (reference
    LsunBedroomDataset._parse_fn, datasets.py:420-427)."""
    return _crop_or_pad(image, size, size), 0


def transform_resize(image, label, seed, rng, size):
    return _resize(image, (size, size)), label


def transform_random_crop(image, label, seed, rng, size):
    """Random square crop then resize (reference `random` crop method,
    datasets.py:455-463). Offsets are floor(u*(h-s)) like the reference's
    `tf.cast([h-size, w-size] * uniform, int32)` — the maximal offset is
    never drawn (measure-zero in TF)."""
    h, w = image.shape[:2]
    s = min(h, w)
    u = rng.uniform(size=2)
    top, left = int((h - s) * u[0]), int((w - s) * u[1])
    return _resize(image, (size, size), crop=(top, left, s, s)), label


def transform_middle_crop(image, label, seed, rng, size):
    """Center square crop then resize (reference `middle` crop method,
    datasets.py:464-470)."""
    h, w = image.shape[:2]
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    return _resize(image, (size, size), crop=(top, left, s, s)), label


def transform_distorted_crop(image, label, seed, rng, size,
                             area_range=(0.5, 1.0),
                             aspect_ratio_range=(1.0, 1.0),
                             max_attempts=100):
    """`tf.image.sample_distorted_bounding_box` with the reference's
    parameters (datasets.py:444-452): square crop (aspect_ratio_range
    [1,1]) covering 50-100% of the image area, uniform offsets. Mirrors the
    TF kernel's integer height sampling (sample_distorted_bounding_box_op);
    falls back to the WHOLE image when no valid crop exists after
    max_attempts (use_image_if_no_bounding_boxes=True semantics)."""
    h, w = image.shape[:2]
    min_area = area_range[0] * h * w
    max_area = area_range[1] * h * w
    for _ in range(max_attempts):
        aspect = float(rng.uniform(*aspect_ratio_range))
        ch = int(round(np.sqrt(min_area / aspect)))
        ch_max = int(round(np.sqrt(max_area / aspect)))
        if round(ch_max * aspect) > w:
            ch_max = int((w + 0.5 - 1e-7) / aspect)
        ch_max = min(ch_max, h)
        ch = min(ch, ch_max)
        if ch < ch_max:
            ch = ch + int(rng.integers(0, ch_max - ch + 1))
        cw = int(round(ch * aspect))
        area = ch * cw
        if area < min_area:
            ch += 1
            cw = int(round(ch * aspect))
            area = ch * cw
        if area > max_area:
            ch -= 1
            cw = int(round(ch * aspect))
            area = ch * cw
        if (area < min_area or area > max_area or cw > w or ch > h
                or cw <= 0 or ch <= 0):
            continue
        top = int(rng.integers(0, h - ch + 1))
        left = int(rng.integers(0, w - cw + 1))
        return _resize(image, (size, size),
                       crop=(top, left, ch, cw)), label
    return _resize(image, (size, size)), label


def _transform_imagenet_image(image, label, seed, rng, size, crop_method):
    """Crop-method dispatch (reference `_transform_imagnet_image` [sic],
    datasets.py:430-476)."""
    if crop_method == "distorted":
        return transform_distorted_crop(image, label, seed, rng, size)
    if crop_method == "random":
        return transform_random_crop(image, label, seed, rng, size)
    if crop_method == "middle":
        return transform_middle_crop(image, label, seed, rng, size)
    if crop_method == "none":
        return _resize(image, (size, size)), label
    raise ValueError(f"Unsupported crop method: {crop_method}")


@gin.configurable("train_imagenet_transform")
def train_imagenet_transform(image, label, seed, rng, size,
                             crop_method="distorted"):
    """Gin surface `train_imagenet_transform.crop_method` (reference
    datasets.py:479-487)."""
    return _transform_imagenet_image(image, label, seed, rng, size,
                                     crop_method)


@gin.configurable("eval_imagenet_transform")
def eval_imagenet_transform(image, label, seed, rng, size,
                            crop_method="middle"):
    """Gin surface `eval_imagenet_transform.crop_method` (reference
    datasets.py:489-497)."""
    return _transform_imagenet_image(image, label, seed, rng, size,
                                     crop_method)


# ---------------------------------------------------------------------------
# ImageDataset
# ---------------------------------------------------------------------------


class ImageDatasetV2:
    """A named image dataset (reference ImageDatasetV2, datasets.py:93-318).

    `train_input_fn`/`eval_input_fn` return iterators of NumPy dicts
    {"images": f32 [B,H,W,C] in [0,1], "labels": int32 [B]} with
    drop_remainder batching. Deterministic given (seed, host) — reference
    pipeline stages shuffle(seed)/transform(seed) (datasets.py:261-318).
    """

    def __init__(self, name, tfds_name, resolution, colors, num_classes,
                 eval_test_samples, seed, train_transform=None,
                 eval_transform=None, num_hosts: Optional[int] = None,
                 host_id: Optional[int] = None, filter_fn=None,
                 label_map_fn=None, eval_split="test"):
        self._name = name
        self._tfds_name = tfds_name
        self._resolution = resolution
        self._colors = colors
        self._num_classes = num_classes
        self._eval_test_samples = eval_test_samples
        self._eval_split = eval_split
        self._seed = 547 if seed is None else int(seed)
        self._train_transform = train_transform or functools.partial(
            transform_resize, size=resolution)
        self._eval_transform = eval_transform or self._train_transform
        self._num_hosts = num_hosts
        self._host_id = host_id
        self._filter_fn = filter_fn
        self._label_map_fn = label_map_fn
        self._source = None

    # -- metadata ----------------------------------------------------------
    @property
    def name(self):
        return self._name

    @property
    def num_classes(self):
        return self._num_classes

    @property
    def eval_test_samples(self):
        """Eval split size for metrics (reference datasets.py:118-122);
        fake data caps at 100 like `--data_fake_dataset` does."""
        return 100 if FAKE_DATASET else self._eval_test_samples

    @property
    def image_shape(self):
        return (self._resolution, self._resolution, self._colors)

    # -- source resolution -------------------------------------------------
    def _get_source(self):
        if self._source is not None:
            return self._source
        if FAKE_DATASET:
            self._source = FakeSource(self.image_shape, self._num_classes)
            return self._source
        directory = os.path.join(DATA_DIR, self._tfds_name)
        if os.path.isdir(directory):
            if glob.glob(os.path.join(directory, "*.npz")):
                self._source = NpzSource(directory)
            else:
                self._source = TFRecordSource(directory)
            return self._source
        raise FileNotFoundError(
            f"Dataset '{self._name}' not found under {directory}. Prepare "
            f".npz or TFRecord shards there, or enable fake data "
            f"(set_fake_dataset(True)).")

    def _resolved_hosts(self):
        """(num_hosts, host_id): the constructor's values, else those of
        the process group (`mesh_utils.process_topology`; (1, 0) outside
        data parallelism). With several hosts each reads its own disjoint
        shard of each epoch (reference abstract_gan.py:41-47,
        datasets.py:147-172)."""
        if self._num_hosts is not None or self._host_id is not None:
            return self._num_hosts or 1, self._host_id or 0
        return mesh_utils.process_topology()

    def _host_seed(self, host_id=None):
        """seed + host index (reference datasets.py:147-172)."""
        hid = self._resolved_hosts()[1] if host_id is None else host_id
        return self._seed + hid

    # -- iteration ---------------------------------------------------------
    def _iter_indices(self, split, shuffle, repeat, seed,
                      shard_by_host=True) -> Iterator[int]:
        src = self._get_source()
        n = src.num_examples(split)
        # Host sharding is a TRAIN-stream concern (per-host input);
        # eval pipelines read the FULL split on whichever host runs them:
        # FID real statistics over a per-host shard would be wrong.
        num_hosts, host_id = (self._resolved_hosts() if shard_by_host
                              else (1, 0))
        epoch = 0
        while True:
            order = np.arange(n)
            if shuffle:
                # The epoch permutation is seeded host-INDEPENDENTLY
                # (self._seed, not the per-host stream seed): all hosts
                # share one permutation and take disjoint stride slices.
                # Shuffling each host's epoch with its own seed would
                # break disjointness — the union of stride slices of
                # DIFFERENT permutations double-samples some examples
                # and misses others. This is
                # deliberately STRONGER than the reference, which never
                # shards: every host there reads the full dataset with
                # only a per-host shuffle seed decorrelating overlapping
                # streams (datasets.py:261-291). The per-host `seed`
                # still keys the per-example transform RNG, so
                # augmentation streams stay host-distinct.
                np.random.Generator(
                    np.random.Philox(
                        key=(self._seed + 977 * epoch) % (2**63))
                ).shuffle(order)
            # Per-host contiguous shard of the (shuffled) epoch.
            shard = order[host_id::num_hosts]
            for idx in shard:
                yield int(idx)
            if not repeat:
                return
            epoch += 1

    def _sidecar_labels(self, split):
        """Replacement labels from sidecar TFRecords when
        `replace_labels.file_pattern` is bound (reference
        datasets.py:174-223): returns (file_names, labels) aligned with
        the dataset's record order, labels being int hard labels or
        softmax(logits) soft labels. None when unconfigured."""
        pattern = _replace_labels_pattern()
        if not pattern:
            return None
        cache = getattr(self, "_sidecar_cache", None)
        if cache is None:
            cache = self._sidecar_cache = {}
        if split in cache:
            return cache[split]
        files = sorted(glob.glob(pattern.format(split=split)))
        if not files:
            raise FileNotFoundError(
                f"replace_labels.file_pattern matched no files: "
                f"{pattern.format(split=split)!r}.")
        names, labels = [], []
        for path in files:
            for payload in _read_tfrecord_payloads(path):
                feats = protobuf.parse_example(payload)
                names.append(feats["file_name"].bytes_list[0].decode())
                if len(feats["label"].float_list):
                    logits = feats["label"].float_list
                    e = np.exp(logits - logits.max())
                    labels.append(e / e.sum())  # Soft label.
                else:
                    labels.append(int(feats["label"].int64_list[0]))
        n = self._get_source().num_examples(self._source_split(split))
        if len(names) != n:
            raise ValueError(
                f"Label sidecar covers {len(names)} records but split "
                f"'{split}' has {n}.")
        cache[split] = (names, labels)
        return cache[split]

    def _iter_examples(self, split, shuffle, repeat, transform, seed,
                       skip_examples=0, num_parallel_calls=8,
                       filter_fn=None, shard_by_host=True):
        """Per-example transform RNG is keyed by the example's PRE-FILTER
        stream position (not a shared sequential generator), so a resumed
        run produces the byte-identical stream an unbroken run would see.
        Without a filter_fn, `skip_examples` fast-forwards WITHOUT
        decoding; with one, skipped examples must still be decoded and
        filtered (their post-filter rank is data-dependent) — they ride
        the parallel pipeline and are discarded (per-position RNG keys
        keep later examples byte-identical either way).

        Decode + transform run on an ordered thread pool (the reference's
        tf.data num_parallel_calls; the native JPEG decode and resize
        release the GIL), with a
        bounded in-flight window so infinite streams don't accumulate."""
        src = self._get_source()
        # The split whose FILES back this stream — subsplit datasets
        # (lsun-bedroom) carve eval out of the train shards, so their
        # index stream uses `split` but the source reads `src_split`.
        src_split = self._source_split(split)
        pre_skip = skip_examples if filter_fn is None else 0
        post_skip = 0 if filter_fn is None else skip_examples

        sidecar = self._sidecar_labels(split)

        def load(args):
            position, idx = args
            rng = np.random.Generator(np.random.Philox(
                key=(seed + 131) % 2**63, counter=position))
            image, label, file_name = src.get(src_split, idx, self._seed)
            if sidecar is not None:
                # Reference _replace_label: double-check instance identity
                # before swapping the label (datasets.py:201-223). The
                # check is MANDATORY — a record without a file_name
                # feature cannot prove its sidecar row is its own (the
                # sidecar may have been written in a different read
                # order), and trusting position silently mislabels every
                # example.
                names, labels = sidecar
                if file_name is None:
                    raise ValueError(
                        f"replace_labels requires a 'file_name' feature "
                        f"on every record of {self._name!r} to verify "
                        f"sidecar alignment (reference datasets.py:"
                        f"201-223); record {idx} has none.")
                if names[idx] != file_name:
                    raise ValueError(
                        f"Label sidecar mismatch at record {idx}: sidecar "
                        f"file_name {names[idx]!r} != dataset "
                        f"{file_name!r}.")
                label = labels[idx]
            if filter_fn is not None and not filter_fn(image, label):
                return None
            image, label = transform(image, label, seed, rng)
            if self._label_map_fn is not None and split == "train":
                # Label replacement (single/random/soft variants) is a
                # TRAIN-pipeline stage (reference datasets.py:552-617);
                # sidecar rows are keyed by train indices.
                label = self._label_map_fn(label, idx, rng)
            return image, label

        def positions():
            position = -1
            for idx in self._iter_indices(split, shuffle, repeat, seed,
                                          shard_by_host=shard_by_host):
                position += 1
                if position < pre_skip:
                    continue
                yield position, idx

        it = positions()
        # Post-filter fast-forward: the Nth *yielded* example must be
        # skipped, and whether an example is yielded is data-dependent, so
        # skipped examples ride the same (parallel) decode pipeline and
        # are discarded until the budget is consumed — a resume deep into
        # a filtered dataset fast-forwards at full pool throughput.
        remaining = post_skip

        def results():
            if num_parallel_calls <= 1:
                for args in it:
                    yield load(args)
                return
            import collections
            import concurrent.futures
            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=num_parallel_calls) as pool:
                window: collections.deque = collections.deque()
                for args in it:
                    window.append(pool.submit(load, args))
                    if len(window) < 2 * num_parallel_calls:
                        continue
                    yield window.popleft().result()
                while window:
                    yield window.popleft().result()

        for item in results():
            if item is None:
                continue
            if remaining > 0:
                remaining -= 1
                continue
            yield item

    def _batch(self, it, batch_size):
        images, labels = [], []
        for image, label in it:
            images.append(image)
            labels.append(label)
            if len(images) == batch_size:
                lab = (np.stack(labels).astype(np.float32)
                       if isinstance(labels[0], np.ndarray)
                       else np.asarray(labels, np.int32))
                yield {"images": np.stack(images).astype(np.float32),
                       "labels": lab}
                images, labels = [], []

    def train_input_fn(self, batch_size, prefetch=2, host_id=None,
                       skip_batches=0):
        """Infinite shuffled deterministic stream (reference
        `train_input_fn`, datasets.py:261-291). `skip_batches`
        fast-forwards without decoding (resume alignment)."""
        seed = self._host_seed(host_id)
        it = self._batch(
            self._iter_examples("train", shuffle=True, repeat=True,
                                transform=self._train_transform, seed=seed,
                                skip_examples=skip_batches * batch_size,
                                filter_fn=self._filter_fn),
            batch_size)
        return _prefetch(it, prefetch)

    def _source_split(self, split):
        """The on-disk split backing `split`'s stream (identity here;
        subsplit datasets read eval examples out of the train shards)."""
        return split

    def _resolve_eval_split(self, split):
        """Resolve the eval split against what's on disk: the requested
        split, else 'validation' (the reference's ImageNet eval split,
        datasets.py:514), else a hard error — NEVER a silent fall back to
        'train', which would compute FID real statistics on training data."""
        src = self._get_source()
        for candidate in dict.fromkeys([split, "validation"]):
            try:
                src.num_examples(candidate)
                return candidate
            except (FileNotFoundError, KeyError):
                continue
        raise FileNotFoundError(
            f"Dataset '{self._name}' has no eval split '{split}' (nor "
            f"'validation'). Refusing to fall back to 'train' — eval "
            f"metrics computed on training data are wrong by construction. "
            f"Pass split='train' explicitly if that is really intended.")

    def eval_input_fn(self, batch_size, split=None, prefetch=2):
        """Deterministic non-repeating eval stream (reference
        `eval_input_fn`, datasets.py:293-318; no filter, no shuffle).
        `split=None` uses the dataset's eval split (`test`, or
        `validation` for ImageNet — reference datasets.py:113,514)."""
        split = self._resolve_eval_split(split or self._eval_split)
        it = self._batch(
            self._iter_examples(split, shuffle=False, repeat=False,
                                transform=self._eval_transform,
                                seed=self._seed, shard_by_host=False),
            batch_size)
        return _prefetch(it, prefetch)

    def load_eval_images(self, num_samples, split=None,
                         failure_on_insufficient_examples=True):
        """Pull `num_samples` eval images to a NumPy array in [0, 255]
        (reference eval_utils.get_real_images, eval_utils.py:87-141),
        tiling 1→3 channels. With failure_on_insufficient_examples=False
        returns however many are available (accuracy.py:75-79 uses
        this for the train split)."""
        split = self._resolve_eval_split(split or self._eval_split)
        out = []
        # Per-example like the reference's get_real_images (its eval ds is
        # unbatched there, eval_utils.py:110-130): a batched stream would
        # drop the remainder and under-deliver for any split size that is
        # not a batch multiple (e.g. cifar10's 10000 vs batch 64).
        it = self._iter_examples(split, shuffle=False, repeat=False,
                                 transform=self._eval_transform,
                                 seed=self._seed, shard_by_host=False)
        for image, _ in it:
            out.append(image)
            if len(out) >= num_samples:
                it.close()
                break
        if not out:
            raise ValueError(f"No eval images for {self._name}.")
        images = np.stack(out)[:num_samples] * 255.0
        if images.shape[-1] == 1:
            images = np.tile(images, (1, 1, 1, 3))
        if len(images) < num_samples and failure_on_insufficient_examples:
            raise ValueError(
                f"Only {len(images)} eval images available, "
                f"need {num_samples}.")
        return images


def _prefetch(it, depth):
    """Background-thread prefetch (replaces tf.data prefetch): the next
    batches are decoded while the trainer runs the current step."""
    if depth <= 0:
        return it
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    error: list = []
    stop = threading.Event()

    def worker():
        try:
            for item in it:
                # Bounded put with a stop check: a consumer that abandons
                # the stream (e.g. load_eval_images taking N images)
                # closes the generator below, and the worker must unwind
                # — not block on a full queue forever, pinning the decode
                # pool and buffered batches.
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    break
        except BaseException as e:  # Surface in the consumer, not silence.
            error.append(e)
        finally:
            if hasattr(it, "close"):
                it.close()
            try:
                q.put_nowait(done)
            except queue.Full:
                pass

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    def gen():
        try:
            while True:
                item = q.get()
                if item is done:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()

    return gen()


# ---------------------------------------------------------------------------
# Registry (reference datasets.py:620-640)
# ---------------------------------------------------------------------------


def _simple(name, tfds_name, resolution, colors, num_classes, eval_samples):
    def ctor(seed):
        return ImageDatasetV2(
            name=name, tfds_name=tfds_name, resolution=resolution,
            colors=colors, num_classes=num_classes,
            eval_test_samples=eval_samples, seed=seed)
    return ctor


def _celeba(seed):
    return ImageDatasetV2(
        name="celeb_a", tfds_name="celeb_a", resolution=64, colors=3,
        num_classes=None, eval_test_samples=10000, seed=seed,
        train_transform=functools.partial(transform_celeba, size=64))


def _celeba_hq_128(seed):
    # Referenced by sndcgan_celebahq128.gin; absent from the reference's
    # registry (README.md:121-123) — provided here.
    return ImageDatasetV2(
        name="celeb_a_hq_128", tfds_name="celeb_a_hq_128", resolution=128,
        colors=3, num_classes=None, eval_test_samples=3000, seed=seed)


def _lsun_bedroom(seed):
    """99/1 train subsplit because the official val split is too small for
    FID (reference datasets.py:407-418, tfds.Split.TRAIN.subsplit([99, 1]));
    modeled as filtering by index hash — deterministic 1% held out for
    eval. Both splits use the reference's crop-or-pad-to-128 parse
    (datasets.py:420-427) — no resize, no random crop."""
    holdout = lambda idx: (idx % 100) == 99  # noqa: E731

    class LsunDataset(ImageDatasetV2):
        def _iter_indices(self, split, shuffle, repeat, seed,
                          shard_by_host=True):
            base = super()._iter_indices(
                "train", shuffle=shuffle, repeat=repeat, seed=seed,
                shard_by_host=shard_by_host)
            want_holdout = split != "train"
            for idx in base:
                if holdout(idx) == want_holdout:
                    yield idx

        def _resolve_eval_split(self, split):
            # Eval is a subsplit of the train files; there is nothing to
            # resolve on disk.
            return split

        def _source_split(self, split):
            # Every stream — train and the 1% holdout — reads the train
            # shards; _iter_indices partitions them by index.
            return "train"

    return LsunDataset(
        name="lsun-bedroom", tfds_name="lsun/bedroom", resolution=128,
        colors=3, num_classes=None, eval_test_samples=30000, seed=seed,
        train_transform=functools.partial(transform_crop_or_pad, size=128),
        eval_transform=functools.partial(transform_crop_or_pad, size=128))


def _imagenet(resolution, eval_samples=50000, name=None, filter_fn=None,
              label_map_fn=None, filter_unlabeled=False):
    """ImageNet family (reference ImagenetDataset, datasets.py:500-533):
    distorted-crop train / middle-crop eval transforms (both with a
    gin-configurable crop_method), eval on the VALIDATION split
    (datasets.py:514), optional label>=0 filter (datasets.py:516-522)."""
    if filter_unlabeled:
        assert filter_fn is None
        filter_fn = lambda image, label: label >= 0  # noqa: E731

    def ctor(seed):
        return ImageDatasetV2(
            name=name or f"imagenet_{resolution}",
            tfds_name="imagenet2012", resolution=resolution, colors=3,
            num_classes=1000, eval_test_samples=eval_samples, seed=seed,
            train_transform=functools.partial(
                train_imagenet_transform, size=resolution),
            eval_transform=functools.partial(
                eval_imagenet_transform, size=resolution),
            filter_fn=filter_fn, label_map_fn=label_map_fn,
            eval_split="validation")
    return ctor


def _imagenet_512_hq400(seed):
    """Only images with min(h, w) >= 400 (reference datasets.py:535-549)."""
    def size_filter(image, label):
        return min(image.shape[0], image.shape[1]) >= 400
    # Filter must run pre-transform; our filter_fn sees the raw image.
    ds = _imagenet(512, name="imagenet_512_hq400")(seed)
    ds._filter_fn = size_filter
    return ds


def _single_class(base_ctor, name):
    """All labels forced to 0 (reference `_graph_single_class`,
    datasets.py:552-566)."""
    def ctor(seed):
        ds = base_ctor(seed)
        ds._name = name
        ds._label_map_fn = lambda label, idx, rng: 0
        ds._num_classes = 1
        return ds
    return ctor


def _random_class(base_ctor, name, num_classes):
    """Labels replaced by uniform random (deterministic per index;
    reference `_graph_random_class`, datasets.py:569-584)."""
    def ctor(seed):
        ds = base_ctor(seed)
        ds._name = name

        def map_fn(label, idx, rng):
            r = np.random.Generator(np.random.Philox(
                key=(ds._seed * 2654435761 + idx) % 2**63))
            return int(r.integers(0, num_classes))
        ds._label_map_fn = map_fn
        return ds
    return ctor


def _soft_labels(base_ctor, name):
    """Soft labels from sidecar `<data_dir>/<name>_soft_labels/<split>.npy`
    [N, num_classes] float (reference SoftLabeledImagenet,
    datasets.py:587-617)."""
    def ctor(seed):
        ds = base_ctor(seed)
        ds._name = name
        cache = {}

        def map_fn(label, idx, rng):
            if "arr" not in cache:
                path = os.path.join(DATA_DIR, f"{name}_soft_labels",
                                    "train.npy")
                if os.path.exists(path):
                    cache["arr"] = np.load(path, mmap_mode="r")
                    # Consistency check (reference asserts sidecar/record
                    # filename alignment, datasets.py:174-223): the
                    # sidecar must cover every training example.
                    n = ds._get_source().num_examples("train")
                    if len(cache["arr"]) < n:
                        raise ValueError(
                            f"Soft-label sidecar {path} has "
                            f"{len(cache['arr'])} rows < {n} train "
                            f"examples.")
                else:
                    cache["arr"] = None
            if cache["arr"] is None:
                onehot = np.zeros(ds.num_classes, np.float32)
                onehot[label] = 1.0
                return onehot
            return np.asarray(cache["arr"][idx], np.float32)
        ds._label_map_fn = map_fn
        return ds
    return ctor


def _convex_polygons(seed):
    """Synthetic convex-polygons dataset ("Are GANs Created Equal?",
    reference colabs/Convex_Polygons_Dataset.ipynb; generator in
    compare_gan_torch/polygons.py — `polygons.write_npz_dataset` creates the
    on-disk 60k/10k splits). Labels are the vertex count; trained
    unconditionally like the paper."""
    return ImageDatasetV2(
        name="convex_polygons", tfds_name="convex_polygons", resolution=28,
        colors=1, num_classes=None, eval_test_samples=10000, seed=seed)


def _convex_polygons_multiclass(seed):
    """Class-conditional convex polygons: 32x32 {3,4,5,6}-gons, labels =
    vertex-count class (polygons.write_multiclass_npz_dataset creates the
    on-disk splits). The conditional convergence-proof dataset: vertex
    count is visually decidable, so per-class sample grids verify that
    cBN + projection-D conditioning learned."""
    return ImageDatasetV2(
        name="convex_polygons_multiclass",
        tfds_name="convex_polygons_multiclass", resolution=32,
        colors=1, num_classes=4, eval_test_samples=10000, seed=seed)


def _convex_polygons_multiclass_128(seed):
    """Flagship-resolution conditional polygons: 128x128 {3,4,5,6}-gons,
    labels = vertex-count class (polygons.write_multiclass128_npz_dataset
    creates the on-disk splits). The BigGAN-128 convergence-proof
    dataset: the reference's headline recipe resolution (reference
    resnet_biggan.py:18-25) with a visually decidable label so the
    per-class grids verify conditioning at 128px."""
    return ImageDatasetV2(
        name="convex_polygons_multiclass_128",
        tfds_name="convex_polygons_multiclass_128", resolution=128,
        colors=1, num_classes=4, eval_test_samples=4000, seed=seed)


def _convex_polygons_partial(seed):
    """Partially-labeled multiclass polygons (20% labeled by default;
    polygons.write_partial_npz_dataset creates the on-disk splits).
    The S3GAN convergence-proof dataset: unlabeled train examples carry
    label -1, which `_get_one_hot_labels` maps to an all-zero row — the
    reference's is_label_available contract (reference s3gan.py:118-122)
    — so the predictor head must impute them. test/holdout are fully
    labeled for held-out predictor accuracy."""
    return ImageDatasetV2(
        name="convex_polygons_partial",
        tfds_name="convex_polygons_partial", resolution=32,
        colors=1, num_classes=4, eval_test_samples=10000, seed=seed)


def _convex_polygons_partial_oriented(seed):
    """Partially-labeled ORIENTED multiclass polygons
    (polygons.write_partial_oriented_npz_dataset): ramp-shaded 32x32
    {3,4,5,6}-gons with only 20% of train labels kept. The S3GAN
    FULL-semantics convergence dataset — both the rotation pretext and
    label imputation are live signals here."""
    return ImageDatasetV2(
        name="convex_polygons_partial_oriented",
        tfds_name="convex_polygons_partial_oriented", resolution=32,
        colors=1, num_classes=4, eval_test_samples=10000, seed=seed)


def _convex_polygons_oriented(seed):
    """Unconditional 32x32 {3,4,5,6}-gons with a vertical shading ramp
    (polygons.write_oriented_npz_dataset creates the on-disk splits).
    The SSGAN convergence-proof dataset: the ramp makes the 4-way
    rotation self-supervision task learnable (uniformly rotated polygons
    alone are rotation-invariant, leaving the rotation head at chance)."""
    return ImageDatasetV2(
        name="convex_polygons_oriented",
        tfds_name="convex_polygons_oriented", resolution=32,
        colors=1, num_classes=None, eval_test_samples=10000, seed=seed)


DATASETS: Dict[str, Callable] = {
    "celeb_a": _celeba,
    "convex_polygons": _convex_polygons,
    "convex_polygons_multiclass": _convex_polygons_multiclass,
    "convex_polygons_multiclass_128": _convex_polygons_multiclass_128,
    "convex_polygons_oriented": _convex_polygons_oriented,
    "convex_polygons_partial": _convex_polygons_partial,
    "convex_polygons_partial_oriented": _convex_polygons_partial_oriented,
    "celeb_a_hq_128": _celeba_hq_128,
    "cifar10": _simple("cifar10", "cifar10", 32, 3, 10, 10000),
    "fashion-mnist": _simple("fashion-mnist", "fashion_mnist", 28, 1, 10,
                             10000),
    "lsun-bedroom": _lsun_bedroom,
    "mnist": _simple("mnist", "mnist", 28, 1, 10, 10000),
    "imagenet_64": _imagenet(64),
    "imagenet_128": _imagenet(128),
    "imagenet_256": _imagenet(256),
    "imagenet_512": _imagenet(512),
    "imagenet_512_hq400": _imagenet_512_hq400,
    "labeled_only_imagenet_128": _imagenet(
        128, name="labeled_only_imagenet_128", filter_unlabeled=True),
    "single_class_imagenet_128": _single_class(
        _imagenet(128), "single_class_imagenet_128"),
    "random_class_imagenet_128": _random_class(
        _imagenet(128), "random_class_imagenet_128", 1000),
    "soft_labeled_imagenet_128": _soft_labels(
        _imagenet(128), "soft_labeled_imagenet_128"),
}


def cut_eval_split(name, num):
    """Register `name` again with `num` eval samples: a polygon set
    written with a test split smaller than the published one."""
    ctor = DATASETS[name]

    def cut(seed):
        ds = ctor(seed)
        ds._eval_test_samples = num
        return ds

    DATASETS[name] = cut


@gin.configurable("dataset")
def get_dataset(name, seed=547) -> ImageDatasetV2:
    """Gin key `dataset.name` (reference get_dataset, datasets.py:643-648).
    The trainer passes the run's seed; the name comes from the config."""
    if name not in DATASETS:
        raise ValueError(f"Dataset {name} is not available. "
                         f"Known: {sorted(DATASETS)}")
    return DATASETS[name](seed)

"""TensorFlow V2 checkpoints ("tensor bundles"), read and written without
TensorFlow.

A checkpoint `<prefix>` is `<prefix>.index` and the shards
`<prefix>.data-<i>-of-<n>`:

* `.index` is a LevelDB-format table. Data blocks hold entries
  [shared key bytes, unshared key bytes, value size (varint32 each),
  unshared key, value] with a restart array at the end; a 5-byte trailer
  follows each block: its compression type (only 0, none, is read; TF
  writes the index uncompressed) and the masked CRC32C of the block and
  type byte. The index block maps a key at or past each data block's last
  key to the block's handle (varint64 offset and size); the metaindex block
  is empty. A 48-byte footer holds the metaindex and index handles, padded
  to 40 bytes, and the magic 0xdb4775248b80fb57.
* The table's first key, "", holds a `BundleHeaderProto`; every other key
  is a variable name holding its `BundleEntryProto` (dtype, shape, shard,
  offset, size, masked CRC32C of the bytes).
* The shards hold the raw little-endian tensor bytes.

Supported dtypes: float32, float64, float16, bfloat16 (read as float32,
exactly), int32, int64, int8/16, uint8/16, bool. String tensors and
partitioned (sliced) variables are refused.

`write_checkpoint` writes `.index`, one data shard and the `checkpoint`
pointer of the directory, and no `.meta` graph: `tf.train.load_checkpoint`
and a Saver built in code restore from it; `tf.train.import_meta_graph`
cannot.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from compare_gan_torch import native
from compare_gan_torch.tf_io import protobuf as pb
from compare_gan_torch.tf_io import tfrecord

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_SIZE = 48
_BLOCK_SIZE = 1 << 16
_RESTART_INTERVAL = 16
# Tensors larger than this are checked only by the native CRC32C: the
# pure-Python loop would take seconds per megabyte.
_PY_CRC_LIMIT = 1 << 20

_DTYPE_OF = {np.dtype(v).newbyteorder("<"): k
             for k, v in pb.NUMPY_DTYPES.items() if k != pb.DT_BFLOAT16}


class CheckpointError(ValueError):
    """A checkpoint file that is malformed, corrupt or unsupported."""


# ---------------------------------------------------------------------------
# The table
# ---------------------------------------------------------------------------


def _read_handle(buf, pos) -> Tuple[Tuple[int, int], int]:
    offset, pos = pb.read_varint(buf, pos)
    size, pos = pb.read_varint(buf, pos)
    return (offset, size), pos


def _block(data: memoryview, handle: Tuple[int, int]) -> memoryview:
    offset, size = handle
    if offset + size + 5 > len(data):
        raise CheckpointError("table block runs past the index file")
    contents = data[offset:offset + size]
    kind = data[offset + size]
    (stored,) = struct.unpack("<I", data[offset + size + 1:offset + size + 5])
    if kind != 0:
        raise CheckpointError(f"compressed table block (type {kind}) is not "
                              f"supported")
    if tfrecord.unmask(stored) != tfrecord.crc32c(
            bytes(contents) + b"\x00"):
        raise CheckpointError("table block checksum mismatch")
    return contents


def _block_entries(block: memoryview) -> List[Tuple[bytes, memoryview]]:
    if len(block) < 4:
        raise CheckpointError("table block too short")
    (restarts,) = struct.unpack("<I", block[-4:])
    end = len(block) - 4 * (restarts + 1)
    if end < 0:
        raise CheckpointError("bad table block restart count")
    out, pos, key = [], 0, b""
    while pos < end:
        shared, pos = pb.read_varint(block, pos)
        unshared, pos = pb.read_varint(block, pos)
        size, pos = pb.read_varint(block, pos)
        if shared > len(key) or pos + unshared + size > end:
            raise CheckpointError("corrupt table block entry")
        key = key[:shared] + bytes(block[pos:pos + unshared])
        pos += unshared
        out.append((key, block[pos:pos + size]))
        pos += size
    return out


def read_table(data: bytes) -> List[Tuple[bytes, memoryview]]:
    """Every (key, value) of a LevelDB-format table, in key order."""
    view = memoryview(data)
    if len(view) < FOOTER_SIZE:
        raise CheckpointError("index file shorter than a table footer")
    footer = view[-FOOTER_SIZE:]
    (magic,) = struct.unpack("<Q", footer[40:48])
    if magic != TABLE_MAGIC:
        raise CheckpointError("not a table file (bad magic)")
    _, pos = _read_handle(footer, 0)  # metaindex: nothing TF needs
    index_handle, _ = _read_handle(footer, pos)
    out = []
    for _, handle in _block_entries(_block(view, index_handle)):
        block_handle, _ = _read_handle(handle, 0)
        out.extend(_block_entries(_block(view, block_handle)))
    return out


class _BlockBuilder:
    def __init__(self, restart_interval: int):
        self._interval = restart_interval
        self.buf = bytearray()
        self._restarts = [0]
        self._count = 0
        self._last = b""

    def add(self, key: bytes, value: bytes) -> None:
        shared = 0
        if self._count < self._interval:
            limit = min(len(key), len(self._last))
            while shared < limit and key[shared] == self._last[shared]:
                shared += 1
        else:
            self._restarts.append(len(self.buf))
            self._count = 0
        self.buf += (pb.encode_varint(shared)
                     + pb.encode_varint(len(key) - shared)
                     + pb.encode_varint(len(value)) + key[shared:] + value)
        self._last = key
        self._count += 1

    def finish(self) -> bytes:
        return bytes(self.buf) + b"".join(
            struct.pack("<I", r) for r in self._restarts) + struct.pack(
                "<I", len(self._restarts))


def write_table(items: List[Tuple[bytes, bytes]]) -> bytes:
    """A LevelDB-format table of (key, value), keys strictly increasing,
    uncompressed blocks of about 64 KiB."""
    out = bytearray()

    def emit(contents: bytes) -> bytes:
        handle = pb.encode_varint(len(out)) + pb.encode_varint(len(contents))
        crc = tfrecord.mask(tfrecord.crc32c(contents + b"\x00"))
        out.extend(contents + b"\x00" + struct.pack("<I", crc))
        return handle

    index = _BlockBuilder(1)
    block, last = _BlockBuilder(_RESTART_INTERVAL), None
    for key, value in items:
        if last is not None and key <= last:
            raise ValueError(f"table keys out of order: {key!r}")
        block.add(key, value)
        last = key
        if len(block.buf) >= _BLOCK_SIZE:
            index.add(key, emit(block.finish()))
            block = _BlockBuilder(_RESTART_INTERVAL)
    if block.buf:
        index.add(last, emit(block.finish()))
    meta_handle = emit(_BlockBuilder(_RESTART_INTERVAL).finish())
    index_handle = emit(index.finish())
    handles = meta_handle + index_handle
    out += handles + b"\x00" * (40 - len(handles)) + struct.pack(
        "<Q", TABLE_MAGIC)
    return bytes(out)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def shard_path(prefix: str, shard: int, num_shards: int) -> str:
    return f"{prefix}.data-{shard:05d}-of-{num_shards:05d}"


class CheckpointReader:
    """The variables of a V2 checkpoint `<prefix>`, as
    `tf.train.load_checkpoint(prefix)` gives them."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        with open(prefix + ".index", "rb") as f:
            items = read_table(f.read())
        if not items or items[0][0] != b"":
            raise CheckpointError(f"{prefix}.index has no bundle header")
        self.header = pb.parse_bundle_header(items[0][1])
        if self.header.endianness != 0:
            raise CheckpointError("big-endian checkpoints are not supported")
        self._entries: Dict[str, pb.BundleEntry] = {
            key.decode("utf-8"): pb.parse_bundle_entry(value)
            for key, value in items[1:]}

    def variable_to_shape_map(self) -> Dict[str, Tuple[int, ...]]:
        return {k: tuple(e.shape) for k, e in self._entries.items()}

    def get_tensor(self, name: str) -> np.ndarray:
        """The variable's value; its bytes' CRC32C is checked first."""
        entry = self._entries[name]
        if entry.sliced:
            raise CheckpointError(f"{name}: partitioned variables are not "
                                  f"supported")
        if entry.dtype not in pb.NUMPY_DTYPES:
            raise CheckpointError(f"{name}: dtype {entry.dtype} is not "
                                  f"supported")
        dtype = pb.NUMPY_DTYPES[entry.dtype]
        count = int(np.prod(entry.shape, dtype=np.int64))
        if entry.size != count * dtype.itemsize:
            raise CheckpointError(f"{name}: {entry.size} bytes for shape "
                                  f"{entry.shape}")
        path = shard_path(self.prefix, entry.shard_id,
                          max(self.header.num_shards, 1))
        with open(path, "rb") as f:
            f.seek(entry.offset)
            raw = f.read(entry.size)
        if len(raw) != entry.size:
            raise CheckpointError(f"{name}: {path} is truncated")
        if not native.available() and entry.size > _PY_CRC_LIMIT:
            raise CheckpointError(
                f"{name}: checking the CRC32C of {entry.size} bytes needs "
                f"the port's native library (g++ could not build it)")
        if tfrecord.crc32c(raw) != tfrecord.unmask(entry.crc32c):
            raise CheckpointError(f"{name}: checksum mismatch in {path}")
        value = np.frombuffer(raw, dtype).reshape(entry.shape)
        if entry.dtype == pb.DT_BFLOAT16:
            return (value.astype(np.uint32) << 16).view(np.float32)
        return value.copy()


def _tensor_bytes(value) -> Tuple[int, Tuple[int, ...], bytes]:
    """(DataType, shape, little-endian bytes) of a numpy array or a torch
    tensor (bfloat16 tensors keep their 16-bit patterns)."""
    if hasattr(value, "detach"):  # a torch tensor
        import torch
        tensor = value.detach().cpu().contiguous()
        if tensor.dtype == torch.bfloat16:
            bits = tensor.view(torch.int16).numpy().astype("<i2")
            return pb.DT_BFLOAT16, tuple(tensor.shape), bits.tobytes()
        value = tensor.numpy()
    array = np.asarray(value)
    dtype = array.dtype.newbyteorder("<")
    if dtype not in _DTYPE_OF:
        raise TypeError(f"cannot write dtype {array.dtype} to a checkpoint")
    return (_DTYPE_OF[dtype], array.shape,
            np.ascontiguousarray(array, dtype).tobytes())


def write_checkpoint(prefix: str, tensors: Dict[str, object]) -> str:
    """Write `tensors` ({name: array}) as the V2 checkpoint `prefix` (one
    data shard, no .meta) and point the directory's `checkpoint` file at
    it. Returns `prefix`."""
    directory = os.path.dirname(os.path.abspath(prefix))
    os.makedirs(directory, exist_ok=True)
    data_path = shard_path(prefix, 0, 1)
    entries, offset = [], 0
    with open(data_path + ".tmp", "wb") as f:
        for name in sorted(tensors):
            dtype, shape, raw = _tensor_bytes(tensors[name])
            f.write(raw)
            entries.append((name.encode("utf-8"), pb.encode_bundle_entry(
                pb.BundleEntry(dtype=dtype, shape=shape, offset=offset,
                               size=len(raw),
                               crc32c=tfrecord.mask(tfrecord.crc32c(raw))))))
            offset += len(raw)
    table = write_table([(b"", pb.encode_bundle_header(1))] + entries)
    with open(prefix + ".index.tmp", "wb") as f:
        f.write(table)
    os.replace(data_path + ".tmp", data_path)
    os.replace(prefix + ".index.tmp", prefix + ".index")
    name = os.path.basename(prefix)
    pointer = os.path.join(directory, "checkpoint")
    with open(pointer + ".tmp", "w") as f:
        f.write(f'model_checkpoint_path: "{name}"\n'
                f'all_model_checkpoint_paths: "{name}"\n')
    os.replace(pointer + ".tmp", pointer)
    return prefix


_POINTER_RE = re.compile(r'^model_checkpoint_path:\s*"(.*)"\s*$')


def latest_checkpoint(directory: str) -> Optional[str]:
    """The prefix the directory's `checkpoint` file names, if its `.index`
    exists (as `tf.train.latest_checkpoint`)."""
    pointer = os.path.join(directory, "checkpoint")
    if not os.path.exists(pointer):
        return None
    with open(pointer) as f:
        for line in f:
            m = _POINTER_RE.match(line.strip())
            if m:
                prefix = m.group(1)
                if not os.path.isabs(prefix):
                    prefix = os.path.join(directory, prefix)
                return prefix if os.path.exists(prefix + ".index") else None
    return None


def resolve_checkpoint(path: str) -> str:
    """A checkpoint prefix from a Saver prefix, a model_dir with a
    `checkpoint` pointer, or a TF-Hub module dir (variables/variables)."""
    if os.path.isdir(path):
        hub_vars = os.path.join(path, "variables", "variables")
        if os.path.exists(hub_vars + ".index"):
            return hub_vars
        latest = latest_checkpoint(path)
        if latest:
            return latest
        raise FileNotFoundError(
            f"No TF checkpoint or hub module found under {path}.")
    return path

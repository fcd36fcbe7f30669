"""A minimal protobuf wire-format decoder and encoder, with typed readers for
the few TensorFlow messages the port reads.

Wire types: 0 varint, 1 fixed64, 2 length-delimited, 5 fixed32. Repeated
scalars are read packed (one length-delimited field) or unpacked (one field
per value), as protobuf parsers must accept both. Unknown fields are skipped.

Messages (field numbers of tensorflow/core/{example,framework,protobuf}):

* `Example` {1: Features {1: map<string, Feature>}}, `Feature` oneof
  {1: BytesList, 2: FloatList, 3: Int64List}, each {1: repeated value};
* `GraphDef` {1: repeated NodeDef {1: name, 2: op, 5: map<string,
  AttrValue>}}, `AttrValue` {8: TensorProto, ...};
* `TensorProto` {1: dtype, 2: tensor_shape, 4: tensor_content, 5: float_val,
  6: double_val, 7: int_val, 10: int64_val, 11: bool_val, 13: half_val};
* `TensorShapeProto` {2: repeated Dim {1: size}, 3: unknown_rank};
* `BundleHeaderProto` {1: num_shards, 2: endianness, 3: VersionDef} and
  `BundleEntryProto` {1: dtype, 2: shape, 3: shard_id, 4: offset, 5: size,
  6: fixed32 crc32c, 7: slices}.

A map<K, V> field is a repeated entry message {1: key, 2: value}.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

Buffer = Union[bytes, bytearray, memoryview]

VARINT, FIXED64, BYTES, FIXED32 = 0, 1, 2, 5

# tensorflow/core/framework/types.proto
DT_FLOAT, DT_DOUBLE, DT_INT32, DT_UINT8, DT_INT16, DT_INT8 = 1, 2, 3, 4, 5, 6
DT_INT64, DT_BOOL, DT_BFLOAT16, DT_UINT16 = 9, 10, 14, 17
DT_HALF, DT_UINT32, DT_UINT64 = 19, 22, 23

# DataType -> numpy dtype of its little-endian bytes (bfloat16 has none:
# its 16-bit patterns are read as uint16 and widened by the caller).
NUMPY_DTYPES = {
    DT_FLOAT: np.dtype("<f4"), DT_DOUBLE: np.dtype("<f8"),
    DT_INT32: np.dtype("<i4"), DT_UINT8: np.dtype("u1"),
    DT_INT16: np.dtype("<i2"), DT_INT8: np.dtype("i1"),
    DT_INT64: np.dtype("<i8"), DT_BOOL: np.dtype("?"),
    DT_UINT16: np.dtype("<u2"), DT_HALF: np.dtype("<f2"),
    DT_UINT32: np.dtype("<u4"), DT_UINT64: np.dtype("<u8"),
    DT_BFLOAT16: np.dtype("<u2"),
}


class DecodeError(ValueError):
    """Bytes that are not a well-formed message."""


# ---------------------------------------------------------------------------
# Wire format
# ---------------------------------------------------------------------------


def read_varint(buf: Buffer, pos: int) -> Tuple[int, int]:
    """(value, position after it) of the varint at `pos` (unsigned)."""
    result = shift = 0
    n = len(buf)
    while True:
        if pos >= n:
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise DecodeError("varint longer than 10 bytes")


def signed64(value: int) -> int:
    """A varint's 64 bits as int64 (int32 and int64 fields both encode
    negatives as 10-byte two's complement)."""
    value &= (1 << 64) - 1
    return value - (1 << 64) if value >= 1 << 63 else value


def signed32(value: int) -> int:
    value &= (1 << 32) - 1
    return value - (1 << 32) if value >= 1 << 31 else value


def iter_fields(buf: Buffer) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of each field of one message:
    an int for varint and fixed fields (unsigned), a memoryview for
    length-delimited ones."""
    view = memoryview(buf)
    pos, n = 0, len(view)
    while pos < n:
        key, pos = read_varint(view, pos)
        field, wire = key >> 3, key & 7
        if wire == VARINT:
            value, pos = read_varint(view, pos)
        elif wire == BYTES:
            size, pos = read_varint(view, pos)
            if pos + size > n:
                raise DecodeError(f"field {field} runs past the message")
            value, pos = view[pos:pos + size], pos + size
        elif wire == FIXED32:
            if pos + 4 > n:
                raise DecodeError("truncated fixed32")
            value, pos = int.from_bytes(view[pos:pos + 4], "little"), pos + 4
        elif wire == FIXED64:
            if pos + 8 > n:
                raise DecodeError("truncated fixed64")
            value, pos = int.from_bytes(view[pos:pos + 8], "little"), pos + 8
        else:
            raise DecodeError(f"unsupported wire type {wire} (field {field})")
        yield field, wire, value


def _packed_varints(data: Buffer) -> List[int]:
    out, pos = [], 0
    while pos < len(data):
        value, pos = read_varint(data, pos)
        out.append(value)
    return out


class _Repeated:
    """Collects one repeated scalar field, packed and unpacked alike."""

    def __init__(self, fixed: Optional[str] = None):
        self._fixed = fixed  # struct format of a fixed-width element
        self.varints: List[int] = []
        self.chunks: List[bytes] = []

    def add(self, wire: int, value) -> None:
        if wire == BYTES:
            if self._fixed is None:
                self.varints.extend(_packed_varints(value))
            else:
                self.chunks.append(bytes(value))
        elif self._fixed is None:
            self.varints.append(value)
        else:
            size = struct.calcsize(self._fixed)
            self.chunks.append(value.to_bytes(size, "little"))

    def array(self, dtype) -> np.ndarray:
        if self._fixed is None:
            return np.array(self.varints, dtype=dtype)
        return np.frombuffer(b"".join(self.chunks), dtype=dtype).copy()


# ---------------------------------------------------------------------------
# tf.train.Example
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Feature:
    """One `tf.train.Feature`: the lists it does not hold are empty."""
    bytes_list: List[bytes] = dataclasses.field(default_factory=list)
    float_list: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float32))
    int64_list: List[int] = dataclasses.field(default_factory=list)


def _parse_feature(buf: Buffer) -> Feature:
    feature = Feature()
    for field, wire, value in iter_fields(buf):
        if wire != BYTES:
            continue
        if field == 1:
            feature.bytes_list = [bytes(v) for f, w, v in iter_fields(value)
                                  if f == 1 and w == BYTES]
        elif field == 2:
            floats = _Repeated("<f")
            for f, w, v in iter_fields(value):
                if f == 1:
                    floats.add(w, v)
            feature.float_list = floats.array("<f4").astype(np.float32)
        elif field == 3:
            ints = _Repeated()
            for f, w, v in iter_fields(value):
                if f == 1:
                    ints.add(w, v)
            feature.int64_list = [signed64(v) for v in ints.varints]
    return feature


def _map_entry(buf: Buffer) -> Tuple[str, memoryview]:
    key, value = "", memoryview(b"")
    for field, wire, v in iter_fields(buf):
        if field == 1 and wire == BYTES:
            key = bytes(v).decode("utf-8")
        elif field == 2 and wire == BYTES:
            value = v
    return key, value


def parse_example(payload: Buffer) -> Dict[str, Feature]:
    """{feature name: Feature} of a serialized `tf.train.Example`."""
    out: Dict[str, Feature] = {}
    for field, wire, features in iter_fields(payload):
        if field != 1 or wire != BYTES:
            continue
        for f, w, entry in iter_fields(features):
            if f == 1 and w == BYTES:
                key, value = _map_entry(entry)
                out[key] = _parse_feature(value)  # Last entry wins.
    return out


# ---------------------------------------------------------------------------
# TensorShapeProto, TensorProto, GraphDef
# ---------------------------------------------------------------------------


def parse_tensor_shape(buf: Buffer) -> Optional[Tuple[int, ...]]:
    """The dims of a `TensorShapeProto`; None for an unknown rank."""
    dims, unknown = [], False
    for field, wire, value in iter_fields(buf):
        if field == 2 and wire == BYTES:
            size = 0
            for f, w, v in iter_fields(value):
                if f == 1 and w == VARINT:
                    size = signed64(v)
            dims.append(size)
        elif field == 3 and wire == VARINT:
            unknown = bool(value)
    return None if unknown else tuple(dims)


def parse_tensor(buf: Buffer) -> np.ndarray:
    """A `TensorProto` as numpy, as `tf.make_ndarray` makes it: from
    `tensor_content` when present, else from the typed value field, a short
    list padded with its last value and an empty one all zeros. bfloat16
    comes back widened to float32 (exact)."""
    dtype, shape, content = 0, (), None
    values = {5: _Repeated("<f"), 6: _Repeated("<d"), 7: _Repeated(),
              10: _Repeated(), 11: _Repeated(), 13: _Repeated()}
    for field, wire, value in iter_fields(buf):
        if field == 1 and wire == VARINT:
            dtype = value
        elif field == 2 and wire == BYTES:
            shape = parse_tensor_shape(value) or ()
        elif field == 4 and wire == BYTES:
            content = value
        elif field in values:
            values[field].add(wire, value)
    if dtype not in NUMPY_DTYPES:
        raise DecodeError(f"unsupported tensor dtype {dtype}")
    np_dtype = NUMPY_DTYPES[dtype]
    count = int(np.prod(shape, dtype=np.int64))
    if content is not None and len(content):
        flat = np.frombuffer(content, dtype=np_dtype).copy()
    elif dtype == DT_FLOAT:
        flat = values[5].array("<f4")
    elif dtype == DT_DOUBLE:
        flat = values[6].array("<f8")
    elif dtype in (DT_HALF, DT_BFLOAT16):
        flat = values[13].array(np.uint32).astype(np.uint16).view(np_dtype)
    elif dtype == DT_INT64:
        flat = np.array([signed64(v) for v in values[10].varints], np.int64)
    elif dtype == DT_BOOL:
        flat = values[11].array(np.bool_)
    elif dtype in (DT_INT32, DT_INT16, DT_INT8, DT_UINT8, DT_UINT16):
        flat = np.array([signed32(v) for v in values[7].varints],
                        np.int64).astype(np_dtype)
    else:
        raise DecodeError(f"tensor dtype {dtype} without tensor_content")
    if flat.size == 0:
        flat = np.zeros(count, np_dtype)
    elif flat.size < count:
        flat = np.pad(flat, (0, count - flat.size), "edge")
    if flat.size != count:
        raise DecodeError(f"{flat.size} values for shape {shape}")
    out = flat.reshape(shape)
    if dtype == DT_BFLOAT16:
        out = (out.astype(np.uint32) << 16).view(np.float32)
    return out


@dataclasses.dataclass
class NodeDef:
    name: str
    op: str
    attr: Dict[str, memoryview]  # name -> serialized AttrValue


def iter_graph_nodes(buf: Buffer) -> Iterator[NodeDef]:
    """The nodes of a serialized `GraphDef`, in order (their tensors stay
    views into `buf` until read)."""
    for field, wire, value in iter_fields(buf):
        if field != 1 or wire != BYTES:
            continue
        node = NodeDef("", "", {})
        for f, w, v in iter_fields(value):
            if w != BYTES:
                continue
            if f == 1:
                node.name = bytes(v).decode("utf-8")
            elif f == 2:
                node.op = bytes(v).decode("utf-8")
            elif f == 5:
                key, attr = _map_entry(v)
                node.attr[key] = attr
        yield node


def tensor_dtype(buf: Buffer) -> int:
    """The DataType of a serialized `TensorProto`, without its values."""
    for field, wire, value in iter_fields(buf):
        if field == 1 and wire == VARINT:
            return value
    return 0


def attr_tensor(attr: Buffer, dtypes=None) -> Optional[np.ndarray]:
    """The tensor of an `AttrValue` (field 8), or None if it holds none or,
    given `dtypes`, one of another DataType."""
    for field, wire, value in iter_fields(attr):
        if field == 8 and wire == BYTES:
            if dtypes is not None and tensor_dtype(value) not in dtypes:
                return None
            return parse_tensor(value)
    return None


# ---------------------------------------------------------------------------
# Checkpoint bundle protos (tensorflow/core/protobuf/tensor_bundle.proto)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BundleHeader:
    num_shards: int = 0
    endianness: int = 0  # 0 little, 1 big


@dataclasses.dataclass
class BundleEntry:
    dtype: int = 0
    shape: Tuple[int, ...] = ()
    shard_id: int = 0
    offset: int = 0
    size: int = 0
    crc32c: int = 0  # masked, as stored
    sliced: bool = False


def parse_bundle_header(buf: Buffer) -> BundleHeader:
    header = BundleHeader()
    for field, wire, value in iter_fields(buf):
        if field == 1 and wire == VARINT:
            header.num_shards = signed32(value)
        elif field == 2 and wire == VARINT:
            header.endianness = value
    return header


def parse_bundle_entry(buf: Buffer) -> BundleEntry:
    entry = BundleEntry()
    for field, wire, value in iter_fields(buf):
        if field == 1 and wire == VARINT:
            entry.dtype = value
        elif field == 2 and wire == BYTES:
            entry.shape = parse_tensor_shape(value) or ()
        elif field == 3 and wire == VARINT:
            entry.shard_id = signed32(value)
        elif field == 4 and wire == VARINT:
            entry.offset = signed64(value)
        elif field == 5 and wire == VARINT:
            entry.size = signed64(value)
        elif field == 6 and wire == FIXED32:
            entry.crc32c = value
        elif field == 7:
            entry.sliced = True
    return entry


# ---------------------------------------------------------------------------
# Encoders
# ---------------------------------------------------------------------------


def encode_varint(value: int) -> bytes:
    value &= (1 << 64) - 1  # Negatives as 10-byte two's complement.
    out = bytearray()
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return encode_varint(field << 3 | wire)


def field_varint(field: int, value: int) -> bytes:
    return _key(field, VARINT) + encode_varint(value)


def field_bytes(field: int, value: Buffer) -> bytes:
    return _key(field, BYTES) + encode_varint(len(value)) + bytes(value)


def field_fixed32(field: int, value: int) -> bytes:
    return _key(field, FIXED32) + int(value).to_bytes(4, "little")


def encode_feature(value) -> bytes:
    """A `Feature` from bytes or a list of bytes (bytes_list), ints
    (int64_list, packed) or floats / a float array (float_list, packed)."""
    if isinstance(value, (bytes, bytearray)):
        value = [value]
    if isinstance(value, (int, np.integer)):
        value = [int(value)]
    if isinstance(value, float):
        value = [value]
    if isinstance(value, np.ndarray) and value.dtype.kind == "f":
        packed = np.asarray(value, "<f4").tobytes()
        return field_bytes(2, field_bytes(1, packed))
    value = list(value)
    if value and isinstance(value[0], (bytes, bytearray)):
        return field_bytes(1, b"".join(field_bytes(1, v) for v in value))
    if value and isinstance(value[0], float):
        return encode_feature(np.asarray(value, np.float32))
    packed = b"".join(encode_varint(int(v)) for v in value)
    return field_bytes(3, field_bytes(1, packed))


def encode_example(features: Dict[str, object]) -> bytes:
    """A serialized `tf.train.Example` of {name: value} (see
    encode_feature), entries in sorted key order."""
    entries = b"".join(
        field_bytes(1, field_bytes(1, k.encode("utf-8"))
                    + field_bytes(2, encode_feature(features[k])))
        for k in sorted(features))
    return field_bytes(1, entries)


def encode_tensor_shape(shape) -> bytes:
    return b"".join(field_bytes(2, field_varint(1, int(d)) if d else b"")
                    for d in shape)


def encode_bundle_header(num_shards: int, producer: int = 1) -> bytes:
    """`BundleHeaderProto`: little-endian, version {producer}."""
    return (field_varint(1, num_shards)
            + field_bytes(3, field_varint(1, producer)))


def encode_bundle_entry(entry: BundleEntry) -> bytes:
    out = field_varint(1, entry.dtype)
    out += field_bytes(2, encode_tensor_shape(entry.shape))
    if entry.shard_id:
        out += field_varint(3, entry.shard_id)
    if entry.offset:
        out += field_varint(4, entry.offset)
    if entry.size:
        out += field_varint(5, entry.size)
    return out + field_fixed32(6, entry.crc32c)

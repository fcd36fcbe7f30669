"""TFRecord framing with its checksums, and CRC32C.

A record is [length: u64 le][masked CRC32C of the length bytes: u32 le]
[payload][masked CRC32C of the payload: u32 le]. TensorFlow masks a CRC as
rotate-right-15 plus 0xa282ead8, and checks both on read.

The port's readers are `datasets._py_iter_tfrecords` and the native library
(`native.index_tfrecords` / `read_record`); this module writes. CRC32C runs
in the native library when it is built; the pure-Python loop that stands in
for it otherwise is meant for small inputs only (about 1 MB/s).
"""

from __future__ import annotations

import struct
from typing import Iterable

from compare_gan_torch import native

_MASK_DELTA = 0xA282EAD8


def _py_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_PY_TABLE = None


def _py_crc32c(data: bytes, crc: int = 0) -> int:
    global _PY_TABLE
    if _PY_TABLE is None:
        _PY_TABLE = _py_table()
    table, c = _PY_TABLE, crc ^ 0xFFFFFFFF
    for b in data:
        c = (c >> 8) ^ table[(c ^ b) & 0xFF]
    return c ^ 0xFFFFFFFF


def crc32c(data, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of `data`, continuing from `crc`."""
    if native.available():
        return native.crc32c(data, crc)
    return _py_crc32c(bytes(data), crc)


def mask(crc: int) -> int:
    """TensorFlow's masked form of a CRC32C."""
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + _MASK_DELTA
            ) & 0xFFFFFFFF


def unmask(masked: int) -> int:
    rot = (masked - _MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


def frame(payload: bytes) -> bytes:
    """One TFRecord: the payload with its length and both masked CRCs."""
    length = struct.pack("<Q", len(payload))
    return b"".join((length, struct.pack("<I", mask(crc32c(length))),
                     payload, struct.pack("<I", mask(crc32c(payload)))))


def write_tfrecords(path: str, payloads: Iterable[bytes]) -> int:
    """Write the payloads as one TFRecord file; returns the record count."""
    count = 0
    with open(path, "wb") as f:
        for payload in payloads:
            f.write(frame(payload))
            count += 1
    return count

"""TensorBoard event files, written and read without TensorFlow.

An event file is a TFRecord file of `Event` messages
(tensorflow/core/util/event.proto): {1: wall_time (double), 2: step
(int64), 3: file_version, 5: Summary, 10: SourceMetadata {1: writer}}.
`Summary` is {1: repeated Value}, and `Summary.Value` {1: tag, 2:
simple_value (float), 8: tensor (TensorProto), 9: SummaryMetadata {1:
PluginData {1: plugin_name}}}.

The writer lays the file out as TensorFlow 2's `tf.summary` does: a first
event that holds only the file version "brain.Event:2", then one event per
summary. A scalar is a rank-0 float32 tensor under the "scalars" plugin; an
image is a string tensor [width, height, PNG...] under the "images" plugin
(`tf.summary.image`, its float pixels turned to uint8 as
`tf.image.convert_image_dtype(..., saturate=True)` turns them).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import socket
import time
from typing import Iterator, List, Optional

import numpy as np

from compare_gan_torch import utils
from compare_gan_torch.tf_io import protobuf as pb
from compare_gan_torch.tf_io import tfrecord

FILE_VERSION = "brain.Event:2"
WRITER = "compare_gan_torch.summaries"
_file_counter = itertools.count()


def event_file_name() -> str:
    """`events.out.tfevents.<seconds>.<host>.<pid>.<n>.v2`, the name
    TensorFlow 2's file writer gives a new event file."""
    return (f"events.out.tfevents.{int(time.time()):010d}."
            f"{socket.gethostname()}.{os.getpid()}.{next(_file_counter)}.v2")


def _event(summary: bytes = b"", step: int = 0,
           wall_time: Optional[float] = None) -> bytes:
    out = pb.field_double(1, time.time() if wall_time is None
                          else wall_time)
    if step:
        out += pb.field_varint(2, step)
    return out + pb.field_bytes(5, summary)


def file_version_event(wall_time: Optional[float] = None) -> bytes:
    return (pb.field_double(1, time.time() if wall_time is None
                            else wall_time)
            + pb.field_bytes(3, FILE_VERSION.encode())
            + pb.field_bytes(10, pb.field_bytes(1, WRITER.encode())))


def _value(tag: str, tensor: bytes, plugin: str) -> bytes:
    metadata = pb.field_bytes(1, pb.field_bytes(1, plugin.encode()))
    return pb.field_bytes(1, pb.field_bytes(1, tag.encode())
                          + pb.field_bytes(8, tensor)
                          + pb.field_bytes(9, metadata))


def scalar_event(tag: str, value: float, step: int,
                 wall_time: Optional[float] = None) -> bytes:
    """One scalar as `tf.summary.scalar` writes it: a rank-0 float32
    tensor (its 4 bytes as tensor_content) under the "scalars" plugin."""
    tensor = (pb.field_varint(1, pb.DT_FLOAT) + pb.field_bytes(2, b"")
              + pb.field_bytes(4, np.float32(value).tobytes()))
    return _event(_value(tag, tensor, "scalars"), step, wall_time)


def image_to_uint8(image) -> np.ndarray:
    """Float pixels to uint8 as `tf.image.convert_image_dtype(x, tf.uint8,
    saturate=True)` does: x * 255.5 in float32, clipped, truncated. NaN
    pixels (G in eval mode before its BN accumulators are filled) become
    0."""
    scaled = np.asarray(image, np.float32) * np.float32(255.5)
    return np.clip(np.nan_to_num(scaled), 0, 255).astype(np.uint8)


def image_event(tag: str, image, step: int,
                wall_time: Optional[float] = None) -> bytes:
    """One image [H, W, C] (float in [0, 1], or uint8) as
    `tf.summary.image` writes a batch of one: the string tensor [width,
    height, PNG] under the "images" plugin."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = image_to_uint8(image)
    h, w = image.shape[:2]
    strings = (str(w).encode(), str(h).encode(), utils.encode_png(image))
    tensor = (pb.field_varint(1, pb.DT_STRING)
              + pb.field_bytes(2, pb.encode_tensor_shape((len(strings),)))
              + b"".join(pb.field_bytes(8, s) for s in strings))
    return _event(_value(tag, tensor, "images"), step, wall_time)


class EventFileWriter:
    """Appends framed events to one new event file in `log_dir`."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, event_file_name())
        self._file = open(self.path, "ab")
        self.write(file_version_event())
        self.flush()

    def write(self, event: bytes) -> None:
        self._file.write(tfrecord.frame(event))

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.close()


@dataclasses.dataclass
class SummaryValue:
    tag: str
    simple_value: Optional[float] = None
    tensor: Optional[memoryview] = None  # A serialized TensorProto.
    plugin: str = ""


@dataclasses.dataclass
class Event:
    wall_time: float = 0.0
    step: int = 0
    file_version: str = ""
    values: List[SummaryValue] = dataclasses.field(default_factory=list)


def _parse_value(buf) -> SummaryValue:
    value = SummaryValue("")
    for field, wire, v in pb.iter_fields(buf):
        if field == 1 and wire == pb.BYTES:
            value.tag = bytes(v).decode("utf-8")
        elif field == 2 and wire == pb.FIXED32:
            value.simple_value = float(
                np.frombuffer(v.to_bytes(4, "little"), "<f4")[0])
        elif field == 8 and wire == pb.BYTES:
            value.tensor = v
        elif field == 9 and wire == pb.BYTES:
            for f, w, plugin_data in pb.iter_fields(v):
                if f == 1 and w == pb.BYTES:
                    for ff, ww, name in pb.iter_fields(plugin_data):
                        if ff == 1 and ww == pb.BYTES:
                            value.plugin = bytes(name).decode("utf-8")
    return value


def parse_event(payload) -> Event:
    event = Event()
    for field, wire, v in pb.iter_fields(payload):
        if field == 1 and wire == pb.FIXED64:
            event.wall_time = float(
                np.frombuffer(v.to_bytes(8, "little"), "<f8")[0])
        elif field == 2 and wire == pb.VARINT:
            event.step = pb.signed64(v)
        elif field == 3 and wire == pb.BYTES:
            event.file_version = bytes(v).decode("utf-8")
        elif field == 5 and wire == pb.BYTES:
            event.values.extend(_parse_value(value)
                                for f, w, value in pb.iter_fields(v)
                                if f == 1 and w == pb.BYTES)
    return event


def iter_events(path: str) -> Iterator[Event]:
    """The events of one event file, in order, every record's CRCs
    checked."""
    for payload in tfrecord.iter_records(path):
        yield parse_event(payload)

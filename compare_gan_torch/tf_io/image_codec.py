"""Image decoding as `tf.io.decode_image(encoded)` does it, without
TensorFlow or PIL.

`decode_image` returns what TensorFlow returns with its defaults (channels
as stored, dtype uint8):

* PNG, here in numpy and the standard library's zlib (the scanline
  unfiltering in the native library when it is built): every color type
  (gray, gray + alpha, RGB, RGBA, palette), bit depths 1-16, the five
  scanline filters and Adam7 interlacing. As TensorFlow's libpng setup:
  gray below 8 bits is scaled to 8 bits; a palette expands to RGB, or RGBA
  when the file has a tRNS chunk; a tRNS chunk of a gray or RGB image is
  ignored; 16-bit samples keep their high byte (`png_set_strip_16`).
* JPEG, by the port's C++ decoder (`csrc/image_decode.cc`, through
  `native.jpeg_decode`), which follows libjpeg's fast integer IDCT, fancy
  upsampling and YCbCr tables as TensorFlow's decode does. It has no Python
  fallback.

GIF, BMP and WebP, which TensorFlow also decodes, are refused.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from compare_gan_torch import native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Adam7: (x0, y0, dx, dy) of the seven passes.
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # color type -> stored samples


def image_format(encoded: bytes) -> str:
    """"png", "jpeg", "gif", "bmp", "webp" or "unknown", by the leading
    bytes as TensorFlow's decode_image tells them apart."""
    head = bytes(encoded[:12])
    if head.startswith(PNG_SIGNATURE):
        return "png"
    if head.startswith(b"\xff\xd8\xff"):
        return "jpeg"
    if head.startswith(b"GIF"):
        return "gif"
    if head.startswith(b"BM"):
        return "bmp"
    if head.startswith(b"RIFF") and head[8:12] == b"WEBP":
        return "webp"
    return "unknown"


def decode_image(encoded: bytes) -> np.ndarray:
    """uint8 [H, W, C] of a PNG or JPEG, as `tf.io.decode_image(encoded)`
    returns it. Raises ValueError for another or a malformed format."""
    kind = image_format(encoded)
    if kind == "png":
        return decode_png(encoded)
    if kind == "jpeg":
        return native.jpeg_decode(encoded)
    raise ValueError(f"cannot decode a {kind} image: the port decodes PNG "
                     f"and JPEG only")


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter(raw: memoryview, rows: int, stride: int, bpp: int) -> np.ndarray:
    """The [rows, stride] bytes of one (sub)image from its filtered
    scanlines (each led by its filter type byte): the native library's loop
    when it is built, else this one (Average and Paeth rows in Python, ~1
    ms per 3 KB row)."""
    if native.available():
        return native.png_unfilter(np.frombuffer(raw, np.uint8), rows,
                                   stride, bpp)
    out = np.zeros((rows, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(rows):
        start = r * (stride + 1)
        kind = raw[start]
        line = np.frombuffer(raw[start + 1:start + 1 + stride], np.uint8)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum per byte lane.
            pad = (-stride) % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)]
                                   ).reshape(-1, bpp).astype(np.uint32)
            cur = (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8
                                                            ).ravel()[:stride]
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            (_average_row if kind == 3 else _paeth_row)(buf, prev.tobytes(),
                                                        bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {kind}")
        out[r] = cur
        prev = out[r]
    return out


def _samples(rows: np.ndarray, width: int, depth: int,
             channels: int) -> np.ndarray:
    """[h, width, channels] samples (uint8, or uint16 at depth 16) of
    unfiltered scanlines."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16)[:, :width * channels
                                                   ].reshape(h, width,
                                                             channels)
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth]
    bits = bits.reshape(h, width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :, None]


def decode_png(data: bytes) -> np.ndarray:
    """uint8 [H, W, C] of a PNG, as TensorFlow's decode_png with channels 0
    and dtype uint8 returns it (see the module docstring)."""
    data = bytes(data)
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG")
    header, palette, trns, idat = None, None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError("PNG lacks IHDR or IDAT")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"bad PNG color type {color} / bit depth {depth}")
    stored = _CHANNELS[color]
    raw = memoryview(zlib.decompress(b"".join(idat)))
    bpp = max(1, stored * depth // 8)

    def pass_samples(offset, w, h):
        stride = (w * stored * depth + 7) // 8
        size = h * (stride + 1)
        if offset + size > len(raw):
            raise ValueError("truncated PNG image data")
        rows = _unfilter(raw[offset:offset + size], h, stride, bpp)
        return _samples(rows, w, depth, stored), offset + size

    if interlace:
        image = np.zeros((height, width, stored),
                         np.uint16 if depth == 16 else np.uint8)
        offset = 0
        for x0, y0, dx, dy in _ADAM7:
            w = (width - x0 + dx - 1) // dx if width > x0 else 0
            h = (height - y0 + dy - 1) // dy if height > y0 else 0
            if w and h:
                part, offset = pass_samples(offset, w, h)
                image[y0::dy, x0::dx] = part
    else:
        image, _ = pass_samples(0, width, height)

    if color == 3:  # Palette -> RGB, or RGBA with tRNS.
        if palette is None:
            raise ValueError("palette PNG lacks PLTE")
        index = image[:, :, 0]
        if index.max(initial=0) >= len(palette):
            raise ValueError("PNG palette index out of range")
        rgb = palette[index]
        if trns is None:
            return rgb
        alpha = np.full(len(palette), 255, np.uint8)
        alpha[:min(len(trns), len(palette))] = np.frombuffer(
            trns[:len(palette)], np.uint8)
        return np.concatenate([rgb, alpha[index][:, :, None]], axis=2)
    if depth == 16:
        return (image >> 8).astype(np.uint8)
    if depth < 8:  # Gray at 1, 2 or 4 bits, scaled to 8 bits.
        return (image * (255 // ((1 << depth) - 1))).astype(np.uint8)
    return image

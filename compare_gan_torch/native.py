"""ctypes bindings for the port's native data-IO runtime (csrc/dataio.cc and
the JPEG decoder csrc/image_decode.cc, one library).

g++ builds the library at first use (never at import) into the git-ignored
`compare_gan_torch/_build/`, under a file name that carries a hash of the
sources and flags, so an edited source is never served by a stale build.
The record, resize and CRC32C entry points degrade gracefully: callers check
`available()` and fall back to the pure-Python paths, so those work without
a toolchain. The JPEG decoder has no fallback: `jpeg_decode` raises,
saying why, when the library cannot be built. ctypes releases the GIL
during each call, and no entry point keeps global state, so threads decode
at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from compare_gan_torch.ops import _build

_SRCS = tuple(os.path.join(_build.SRC_DIR, name)
              for name in ("dataio.cc", "image_decode.cc"))
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_build_error = ""  # why the library is unavailable, for the JPEG error


def _library_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(_build.BUILD_DIR,
                        f"libdataio-{h.hexdigest()[:16]}.so")


def _build_library() -> Optional[str]:
    """The up-to-date library's path, compiling it if needed; None when
    there is no working g++. Concurrent builders each write a private
    temporary file and rename it into place."""
    global _build_error
    path = _library_path()
    if os.path.exists(path):
        return path
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        subprocess.run(["g++", *_FLAGS, *_SRCS, "-o", tmp], check=True,
                       capture_output=True, timeout=300)
    except FileNotFoundError:
        _build_error = "g++ was not found"
        return None
    except subprocess.CalledProcessError as e:
        _build_error = "g++ failed: " + e.stderr.decode(
            errors="replace")[-2000:]
        return None
    except subprocess.SubprocessError as e:
        _build_error = f"g++ failed: {e}"
        return None
    os.replace(tmp, path)
    return path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build_library()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            _build_error = f"loading {path} failed: {e}"
            return None
        c_char_p, i64 = ctypes.c_char_p, ctypes.c_int64
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.tfrecord_count.restype = i64
        lib.tfrecord_count.argtypes = [c_char_p]
        lib.tfrecord_index.restype = i64
        lib.tfrecord_index.argtypes = [c_char_p, i64p, i64]
        lib.tfrecord_read.restype = i64
        lib.tfrecord_read.argtypes = [c_char_p, i64, u8p, i64]
        lib.resize_area_f32.restype = None
        lib.resize_area_f32.argtypes = [f32p, i64, i64, i64, f32p, i64, i64]
        lib.resize_bilinear_f32.restype = None
        lib.resize_bilinear_f32.argtypes = [f32p, i64, i64, i64, f32p, i64,
                                            i64]
        lib.crop_resize_f32.restype = None
        lib.crop_resize_f32.argtypes = [f32p, i64, i64, i64, i64, i64, i64,
                                        i64, f32p, i64, i64]
        lib.crop_resize_bilinear_f32.restype = None
        lib.crop_resize_bilinear_f32.argtypes = [f32p, i64, i64, i64, i64,
                                                 i64, i64, i64, f32p, i64,
                                                 i64]
        lib.u8_to_f32_scaled.restype = None
        lib.u8_to_f32_scaled.argtypes = [u8p, i64, f32p]
        lib.png_unfilter.restype = i64
        lib.png_unfilter.argtypes = [u8p, i64, i64, i64, u8p]
        lib.crc32c_extend.restype = ctypes.c_uint32
        lib.crc32c_extend.argtypes = [ctypes.c_uint32, ctypes.c_char_p, i64]
        lib.jpeg_header.restype = ctypes.c_int
        lib.jpeg_header.argtypes = [ctypes.c_char_p, i64, i64p,
                                    ctypes.c_char_p, i64]
        lib.jpeg_decode.restype = ctypes.c_int
        lib.jpeg_decode.argtypes = [ctypes.c_char_p, i64, u8p, i64,
                                    ctypes.c_char_p, i64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def index_tfrecords(path: str) -> List[int]:
    """Byte offsets of every record in a TFRecord file."""
    lib = _load()
    assert lib is not None
    count = lib.tfrecord_count(path.encode())
    if count < 0:
        raise IOError(f"Cannot index TFRecord file {path}.")
    offsets = np.empty(count, np.int64)
    got = lib.tfrecord_index(
        path.encode(), offsets.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)), count)
    return offsets[:got].tolist()


_read_local = threading.local()


def read_record(path: str, offset: int, max_size: int = 64 << 20) -> bytes:
    """Read one record. The scratch buffer is thread-local and reused: this
    sits on the per-example decode path, and a fresh multi-MB np.empty per
    call would mmap/munmap at the pipeline rate."""
    lib = _load()
    assert lib is not None
    buf = getattr(_read_local, "buf", None)
    if buf is None:
        buf = _read_local.buf = np.empty(1 << 20, np.uint8)
    while True:
        got = lib.tfrecord_read(
            path.encode(), offset,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf))
        if got >= 0:
            return buf[:got].tobytes()
        if got != -2:
            # -1: an IO error (missing file, bad offset, truncated record):
            # fail now rather than grow and retry.
            raise IOError(f"IO error reading record at {path}:{offset}.")
        if len(buf) >= max_size:
            raise IOError(
                f"Record at {path}:{offset} exceeds max_size={max_size}.")
        # -2: the record is larger than the scratch buffer: grow and retry.
        buf = _read_local.buf = np.empty(len(buf) * 8, np.uint8)


def _resize_call(fn, image: np.ndarray, size: Tuple[int, int],
                 *crop: int) -> np.ndarray:
    image = np.ascontiguousarray(image, np.float32)
    h, w, c = image.shape
    oh, ow = size
    out = np.empty((oh, ow, c), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    fn(image.ctypes.data_as(f32p), h, w, c, *crop, out.ctypes.data_as(f32p),
       oh, ow)
    return out


def resize_area(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Box/area resize of an f32 HWC image."""
    return _resize_call(_load().resize_area_f32, image, size)


def resize_bilinear(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """TF1 legacy bilinear resize of an f32 HWC image (align_corners=False,
    as tf.image.resize_images; reference datasets.py:474-476)."""
    return _resize_call(_load().resize_bilinear_f32, image, size)


def crop_resize(image: np.ndarray, top: int, left: int, ch: int, cw: int,
                size: Tuple[int, int]) -> np.ndarray:
    """Fused crop + area resize (no intermediate copy)."""
    return _resize_call(_load().crop_resize_f32, image, size, top, left, ch,
                        cw)


def crop_resize_bilinear(image: np.ndarray, top: int, left: int, ch: int,
                         cw: int, size: Tuple[int, int]) -> np.ndarray:
    """Fused crop + TF1-legacy bilinear resize (no intermediate copy)."""
    return _resize_call(_load().crop_resize_bilinear_f32, image, size, top,
                        left, ch, cw)


def u8_to_f32(raw: np.ndarray) -> np.ndarray:
    lib = _load()
    assert lib is not None
    raw = np.ascontiguousarray(raw, np.uint8)
    out = np.empty(raw.shape, np.float32)
    lib.u8_to_f32_scaled(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), raw.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def png_unfilter(raw: np.ndarray, rows: int, stride: int,
                 bpp: int) -> np.ndarray:
    """[rows, stride] bytes of PNG scanlines from their filtered form
    (`raw`: uint8, rows * (stride + 1) bytes)."""
    lib = _load()
    assert lib is not None
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size < rows * (stride + 1):
        raise ValueError("truncated PNG image data")
    out = np.empty((rows, stride), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if lib.png_unfilter(raw.ctypes.data_as(u8p), rows, stride, bpp,
                        out.ctypes.data_as(u8p)) != 0:
        raise ValueError("bad PNG filter type")
    return out


def crc32c(data, crc: int = 0) -> int:
    """CRC32C of `data` (bytes-like), continuing from `crc`."""
    lib = _load()
    assert lib is not None
    data = bytes(data) if not isinstance(data, bytes) else data
    return int(lib.crc32c_extend(crc, data, len(data)))


def jpeg_decode(data: bytes) -> np.ndarray:
    """A JPEG as uint8 [H, W, C] (C = 1 or 3), as tf.io.decode_image
    returns it. Raises ValueError for a file the decoder refuses or cannot
    read, RuntimeError when the library cannot be built."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "JPEG decoding needs the port's native library, which could not "
            f"be built ({_build_error or 'unknown reason'}); it has no "
            "Python fallback.")
    data = bytes(data) if not isinstance(data, bytes) else data
    err = ctypes.create_string_buffer(512)
    dims = np.zeros(3, np.int64)
    if lib.jpeg_header(data, len(data), dims.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)), err, len(err)) != 0:
        raise ValueError(err.value.decode(errors="replace"))
    out = np.empty(tuple(int(d) for d in dims), np.uint8)
    if lib.jpeg_decode(data, len(data), out.ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8)), out.size, err, len(err)) != 0:
        raise ValueError(err.value.decode(errors="replace"))
    return out

"""Small helpers shared by the port (counterparts in
compare_gan_tpu/utils/misc.py, which imports jax)."""

from __future__ import annotations

import inspect
import math

import numpy as np
import torch


def rotate_images(images, rot90_scalars=(0, 1, 2, 3)):
    """Rotated copies of an NHWC batch, grouped rotation-major: k
    quarter-turns of each image as `jnp.rot90(x, k, axes=(1, 2))` turns it
    (misc.py:53-64). Data movement only, so bitwise equal to the JAX
    function."""
    rotations = {
        0: lambda x: x,
        1: lambda x: x.transpose(1, 2).flip(1),
        2: lambda x: x.flip(1).flip(2),
        3: lambda x: x.transpose(1, 2).flip(2),
    }
    return torch.cat([rotations[i](images) for i in rot90_scalars], dim=0)


def accepted_args(fn):
    """The names of the kwargs fn accepts (None: any), looking through
    gin-configurable wrappers and classes to the real signature."""
    target = fn
    while hasattr(target, "__wrapped_fn__"):
        target = target.__wrapped_fn__
    if inspect.isclass(target):
        target = target.__init__
    params = inspect.signature(target).parameters
    if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return None
    return params.keys()


def call_with_accepted_args(fn, **kwargs):
    """Call fn with only the kwargs its signature accepts."""
    accepted = accepted_args(fn)
    if accepted is None:
        return fn(**kwargs)
    return fn(**{k: v for k, v in kwargs.items() if k in accepted})


def image_grid(images, grid_shape=None):
    """Tile [N, H, W, C] into one [gh*H, gw*W, C] image (summaries,
    modular_gan.py:308-343). Without `grid_shape` the grid is the smallest
    square-ish one that holds N; empty cells are black."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    if grid_shape is None:
        gw = int(math.ceil(math.sqrt(n)))
        gh = int(math.ceil(n / gw))
    else:
        gh, gw = grid_shape
        if n > gh * gw:
            images, n = images[:gh * gw], gh * gw  # Only first gh*gw used.
    pad = gh * gw - n
    if pad > 0:
        images = np.concatenate(
            [images, np.zeros((pad, h, w, c), images.dtype)], 0)
    return (images.reshape(gh, gw, h, w, c)
            .transpose(0, 2, 1, 3, 4)
            .reshape(gh * h, gw * w, c))


def encode_png(image) -> bytes:
    """A uint8 [H, W] or [H, W, C] (C in 1-4) array as the bytes of an
    8-bit PNG, with zlib and no other dependency."""
    import struct
    import zlib

    arr = np.ascontiguousarray(image, np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    # Each scanline starts with filter type 0 (none).
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          arr.reshape(h, w * c)], axis=1).tobytes()

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    return b"".join((
        b"\x89PNG\r\n\x1a\n",
        chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)),
        chunk(b"IDAT", zlib.compress(raw)),
        chunk(b"IEND", b"")))


def write_png(path, image):
    """Write a uint8 [H, W] or [H, W, C] array as an 8-bit PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(image))


def save_images(images, image_path):
    """Save an image, or a grid of a [N, H, W, C] batch, in [0, 1] as a PNG
    (misc.save_images of the JAX package)."""
    arr = np.asarray(images)
    if arr.ndim == 4:
        arr = image_grid(arr)
    write_png(image_path, np.clip(arr * 255.0, 0, 255).astype(np.uint8))

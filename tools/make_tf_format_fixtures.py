"""Write the image fixtures of the port's TensorFlow-format tests and of
chip_smoke.py's TFRecord phase into tests/torch_fixtures/.

    python tools/make_tf_format_fixtures.py

Needs TensorFlow and PIL (the encoders); the card's machine has neither,
which is why the files are committed. Each image is written as encoded
bytes (`<name>.jpg` / `<name>.png`) beside `tf.io.decode_image`'s output for
it (`<name>.npy`, uint8 HWC): the goldens the port's decoder is held to.
`tests/test_torch_tf_images.py` re-derives every golden with TensorFlow
when it is installed, so a fixture that drifts fails there.

The JPEGs cover baseline 4:2:0 and 4:4:4, progressive, grayscale, 4:2:2,
and restart intervals, at odd sizes so partial MCUs and edge upsampling
run; `jpeg_420_q85_128x96` is the decode-rate image. The PNGs cover 8- and
16-bit gray and color, alpha, sub-byte gray, a palette with tRNS, and Adam7
interlacing with all five scanline filters (written by the small encoder
below, since neither TensorFlow nor PIL writes interlaced PNGs).
"""

import io
import os
import struct
import sys
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "torch_fixtures")
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def smooth_image(h, w, c, seed, noise=10.0):
    """A photo-like uint8 image: low-frequency waves plus mild noise, so
    JPEGs of it are small but every coefficient band is used."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    layers = [np.sin(x / (5.0 + 3 * k) + k) * 55
              + np.cos(y / (4.0 + 2 * k) - 2 * k) * 45 + 128
              for k in range(c)]
    image = np.stack(layers, -1) + rng.randn(h, w, c) * noise
    return np.clip(image, 0, 255).astype(np.uint8)


def _filter_row(kind, cur, prev, bpp):
    out = bytearray(len(cur))
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (cur[i] - pred) & 0xFF
    return bytes(out)


def encode_png(samples, depth, color, interlace, palette=None, trns=None):
    """A PNG of `samples` ([H, W, C] ints at `depth` bits), row r of each
    pass filtered with filter type r % 5."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)

    def rows(sub):
        raw, prev = b"", None
        for r in range(sub.shape[0]):
            if depth == 16:
                line = sub[r].astype(">u2").tobytes()
            elif depth == 8:
                line = sub[r].astype(np.uint8).tobytes()
            else:
                bits = np.unpackbits(sub[r].astype(np.uint8).reshape(-1, 1),
                                     axis=1)[:, 8 - depth:].ravel()
                line = np.packbits(bits).tobytes()
            prev = prev if prev is not None else bytes(len(line))
            kind = r % 5
            raw += bytes([kind]) + _filter_row(kind, line, prev, bpp)
            prev = line
        return raw

    if interlace:
        data = b"".join(rows(samples[y0::dy, x0::dx])
                        for x0, y0, dx, dy in ADAM7
                        if w > x0 and h > y0)
    else:
        data = rows(samples)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", bytes(trns))
    return out + chunk(b"IDAT", zlib.compress(data, 9)) + chunk(b"IEND", b"")


def jpeg_fixtures(tf):
    from PIL import Image

    def pil(image, **kw):
        f = io.BytesIO()
        Image.fromarray(image.squeeze()).save(f, "JPEG", **kw)
        return f.getvalue()

    color = smooth_image(29, 43, 3, 0)
    return {
        "jpeg_420_q90": tf.io.encode_jpeg(color, quality=90).numpy(),
        "jpeg_444_q90": tf.io.encode_jpeg(
            color, quality=90, chroma_downsampling=False).numpy(),
        "jpeg_420_progressive": tf.io.encode_jpeg(
            smooth_image(35, 27, 3, 1), quality=85,
            progressive=True).numpy(),
        "jpeg_gray": tf.io.encode_jpeg(smooth_image(31, 22, 1, 2),
                                       quality=80).numpy(),
        "jpeg_420_restart": pil(smooth_image(41, 50, 3, 3), quality=88,
                                subsampling=2, restart_marker_blocks=3),
        "jpeg_422_progressive_restart": pil(
            smooth_image(26, 37, 3, 4), quality=75, subsampling=1,
            progressive=True, restart_marker_rows=1),
        "jpeg_420_q85_128x96": tf.io.encode_jpeg(
            smooth_image(96, 128, 3, 5), quality=85).numpy(),
    }


def png_fixtures():
    from PIL import Image

    def pil(image, **kw):
        f = io.BytesIO()
        image.save(f, "PNG", **kw)
        return f.getvalue()

    rng = np.random.RandomState(7)
    rgb = smooth_image(19, 23, 3, 6)
    palette = rng.randint(0, 256, (16, 3))
    return {
        "png_rgb8": pil(Image.fromarray(rgb)),
        "png_rgba8": pil(Image.fromarray(smooth_image(17, 21, 4, 8))),
        "png_gray8": pil(Image.fromarray(rgb[:, :, 0])),
        "png_gray16": encode_png(
            rng.randint(0, 65536, (13, 15, 1)), 16, 0, False),
        "png_rgb16": encode_png(
            rng.randint(0, 65536, (11, 9, 3)), 16, 2, False),
        "png_gray2_interlaced": encode_png(
            rng.randint(0, 4, (21, 19, 1)), 2, 0, True),
        "png_palette4_trns": encode_png(
            rng.randint(0, 16, (15, 18, 1)), 4, 3, False, palette=palette,
            trns=[0, 90, 255, 17]),
        "png_rgb8_interlaced": encode_png(
            smooth_image(22, 25, 3, 9).astype(np.int64), 8, 2, True),
        "png_gray_alpha16_interlaced": encode_png(
            rng.randint(0, 65536, (9, 14, 2)), 16, 4, True),
    }


def main():
    import tensorflow as tf
    os.makedirs(OUT, exist_ok=True)
    fixtures = {**{k + ".jpg": v for k, v in jpeg_fixtures(tf).items()},
                **{k + ".png": v for k, v in png_fixtures().items()}}
    for name, data in sorted(fixtures.items()):
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        golden = tf.io.decode_image(data).numpy()
        np.save(os.path.join(OUT, os.path.splitext(name)[0] + ".npy"),
                golden)
        print(f"{name}: {len(data)} bytes, decoded {golden.shape} "
              f"{golden.dtype}")


if __name__ == "__main__":
    sys.exit(main())

"""Minimal PNG codec for 8-bit grayscale images (stdlib `zlib` + numpy).

KITTI odometry's `image_0` frames and the synthetic dataset's images and
semantic labels are all 8-bit single-channel, non-interlaced PNGs, so
this is all the image IO the pipeline needs.  Any other PNG flavour
(colour, palette, 16-bit, interlaced) raises `ValueError` naming the
field that is out of scope.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from mono_lidar_depth_tpu.io import native

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(img: np.ndarray) -> bytes:
    """[H, W] uint8 → PNG bytes (filter type 0 on every row)."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"expected a 2-D uint8 image, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path, img: np.ndarray) -> None:
    Path(path).write_bytes(encode_png(img))


def _unfilter(rows: np.ndarray) -> np.ndarray:
    """[H, W + 1] scanlines (filter byte first) → [H, W] pixels: undo PNG
    filters 0-4 for one byte per pixel.

    The native library does it in one sequential pass.  Without it, each
    byte depends only on its left, upper and upper-left neighbours, so
    all bytes of one anti-diagonal are independent: the image is rebuilt
    in H + W - 1 vectorized steps over a skewed copy in which each
    anti-diagonal is one contiguous column."""
    if native.native_available():
        return native.png_unfilter_native(rows)
    filters, raw = rows[:, 0], rows[:, 1:]
    if not filters.any():
        return np.ascontiguousarray(raw)
    h, w = raw.shape
    r, i = np.indices((h, w))
    # k[r + 1, t + 2] is pixel (r, t - r); row 0 and columns 0-1 are the
    # zero border that filters read above and left of the image.
    k = np.zeros((h + 1, h + w + 1), np.int16, order="F")
    skewed = np.zeros((h, h + w - 1), np.int16, order="F")
    skewed[r, r + i] = raw
    f = filters.astype(np.int16)
    n_other = np.concatenate([[0], np.cumsum(filters != 4)])
    for t in range(h + w - 1):
        lo, hi = max(0, t - w + 1), min(h, t + 1)
        a, b, c = k[lo + 1:hi + 1, t + 1], k[lo:hi, t + 1], k[lo:hi, t]
        # Paeth distances from p = a + b - c: |p-a|, |p-b|, |p-c|
        da, db = a - c, b - c
        pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        if n_other[hi] != n_other[lo]:  # rows other than Paeth
            pred = np.choose(f[lo:hi], (0 * a, a, b, (a + b) >> 1, pred))
        k[lo + 1:hi + 1, t + 2] = (skewed[lo:hi, t] + pred) & 0xFF
    return k[r + 1, r + i + 2].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → [H, W] uint8 (8-bit grayscale, non-interlaced)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG has no IHDR or IDAT chunk")
    w, h, depth, colour, compression, filter_method, interlace = header
    for name, got, want in (("bit depth", depth, 8),
                            ("colour type", colour, 0),
                            ("compression", compression, 0),
                            ("filter method", filter_method, 0),
                            ("interlace", interlace, 0)):
        if got != want:
            raise ValueError(f"unsupported PNG {name} {got}: only 8-bit "
                             "grayscale non-interlaced images are read")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != h * (w + 1):
        raise ValueError(f"PNG data is {rows.size} bytes, expected "
                         f"{h * (w + 1)} for {w}x{h}")
    rows = rows.reshape(h, w + 1)
    if rows[:, 0].max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {rows[:, 0].max()}")
    return _unfilter(rows)


def read_png(path) -> np.ndarray:
    return decode_png(Path(path).read_bytes())

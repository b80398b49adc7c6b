"""The stdlib PNG codec (io/png.py): round trips through every scanline
filter, the committed KITTI-format fixture images, and clear errors for
formats outside 8-bit grayscale.  Decoding runs through both unfilter
paths: the native library's and the numpy fallback."""

import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from mono_lidar_depth_tpu.io import native
from mono_lidar_depth_tpu.io.png import decode_png, encode_png, read_png

FIXTURES = Path(__file__).parent / "fixtures"


def _filter_row(kind, row, prior):
    """Reference PNG filter of one scanline, pixel by pixel."""
    out = []
    for i, x in enumerate(row):
        a = row[i - 1] if i else 0
        b = prior[i]
        c = prior[i - 1] if i else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out.append((x - pred) % 256)
    return out


def _png_with_filters(img, kinds):
    h, w = img.shape
    prior = [0] * w
    raw = bytearray()
    for r in range(h):
        row = [int(v) for v in img[r]]
        raw.append(kinds[r])
        raw.extend(_filter_row(kinds[r], row, prior))
        prior = row

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.fixture(params=["native", "numpy"])
def unfilter(request, monkeypatch):
    """Which unfilter path decode_png takes."""
    if request.param == "native":
        assert native.native_available(), "native library did not build"
    else:
        monkeypatch.setattr(native, "native_available", lambda: False)
    return request.param


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, "mixed"])
def test_png_round_trip_through_filter(kind, unfilter):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (13, 17), dtype=np.uint8)
    kinds = (list(rng.integers(0, 5, 13)) if kind == "mixed"
             else [kind] * 13)
    np.testing.assert_array_equal(decode_png(_png_with_filters(img, kinds)),
                                  img)


def test_png_encode_decode_round_trip(tmp_path):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    np.testing.assert_array_equal(decode_png(encode_png(img)), img)


@pytest.mark.parametrize("frame", [0, 1])
def test_png_decodes_kitti_fixture_images(frame, unfilter):
    sys.path.insert(0, str(FIXTURES))
    from make_kitti_fixture import make_image

    path = (FIXTURES / "kitti_mini" / "sequences" / "04" / "image_0"
            / f"{frame:06d}.png")
    img = read_png(path)
    assert img.shape == (370, 1226) and img.dtype == np.uint8
    np.testing.assert_array_equal(img, make_image(frame))


def test_png_paeth_rows_below_other_filters(unfilter):
    """A wide image whose Paeth rows follow rows of every other filter,
    as adaptive encoders write them."""
    rng = np.random.default_rng(5)
    img = np.cumsum(rng.integers(0, 9, (9, 300)), axis=1).astype(np.uint8)
    kinds = [1, 2, 0, 3, 4, 4, 2, 4, 4]
    np.testing.assert_array_equal(decode_png(_png_with_filters(img, kinds)),
                                  img)


def test_png_rejects_colour_images():
    rgb = encode_png(np.zeros((4, 4), np.uint8)).replace(
        struct.pack(">IIBBBBB", 4, 4, 8, 0, 0, 0, 0),
        struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 0))
    with pytest.raises(ValueError, match="colour type 2"):
        decode_png(rgb)

"""vfi_tpu_torch/utils/png.py against PIL on the CPU: the port's files read
by PIL, PIL's files read by the port, and rows of each of the five PNG filter
types.  Gate: pixel values equal (the codec is lossless)."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from vfi_tpu_torch.utils import png
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

# Odd sizes, gray and RGB; smooth and noisy content, so PIL picks several filters.
CASES = [(1, 1, 1), (7, 13, 1), (33, 20, 3), (5, 64, 3), (48, 31, 1)]


def _image(h, w, c, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = (127 + 100 * np.sin(xx / 5.0 + yy / 7.0))[..., None] + np.arange(c) * 20
    noisy = rng.randint(0, 256, (h, w, c))
    img = np.where((xx < w // 2)[..., None], smooth, noisy).clip(0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


@pytest.mark.parametrize("h,w,c", CASES)
def test_port_writes_what_pil_reads(tmp_path, h, w, c):
    img = _image(h, w, c, seed=h * w)
    path = str(tmp_path / "a.png")
    png.write_png(path, img[..., None] if c == 1 and h % 2 else img)  # [H, W, 1] takes the gray path too
    got = np.asarray(Image.open(path))
    assert got.dtype == np.uint8 and np.array_equal(got, img)
    assert Image.open(path).mode == ("L" if c == 1 else "RGB")


@pytest.mark.parametrize("h,w,c", CASES)
def test_port_reads_what_pil_writes(tmp_path, h, w, c):
    img = _image(h, w, c, seed=h + w)
    path = str(tmp_path / "b.png")
    Image.fromarray(img).save(path)
    got = png.read_png(path)
    assert got.dtype == np.uint8 and np.array_equal(got, np.asarray(Image.open(path)))
    assert np.array_equal(got, img)


def _filtered(raw: np.ndarray, kind: int, prior: np.ndarray, bpp: int) -> bytes:
    """Filter one row of bytes with PNG filter ``kind`` (the encoder's side)."""
    out = bytearray()
    for i, x in enumerate(raw.tolist()):
        a = int(raw[i - bpp]) if i >= bpp else 0
        b = int(prior[i])
        c = int(prior[i - bpp]) if i >= bpp else 0
        p = a + b - c
        paeth = min((abs(p - a), 0, a), (abs(p - b), 1, b), (abs(p - c), 2, c))[2]
        pred = [0, a, b, (a + b) // 2, paeth][kind]
        out.append((x - pred) & 0xFF)
    return bytes([kind]) + bytes(out)


@pytest.mark.parametrize("c", [1, 3])
def test_port_reads_every_filter_type(c):
    """Rows filtered None, Sub, Up, Average and Paeth in turn, read by PIL and the port."""
    img = _image(15, 9, c, seed=c)
    rows = img.reshape(15, -1)
    prior = np.zeros(rows.shape[1], np.uint8)
    data = b""
    for y, row in enumerate(rows):
        data += _filtered(row, y % 5, prior, c)
        prior = row
    header = struct.pack(">IIBBBBB", 9, 15, 8, 0 if c == 1 else 2, 0, 0, 0)
    buf = png.SIGNATURE + png._chunk(b"IHDR", header) + png._chunk(b"IDAT", zlib.compress(data)) + png._chunk(
        b"IEND", b"")
    want = np.asarray(Image.open(io.BytesIO(buf)))
    assert np.array_equal(want, img)
    assert np.array_equal(png.decode_png(buf), img)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_port_reads_random_row_filters(c):
    """Every row's filter type drawn at random, as adaptive encoders pick
    them, on gray, gray + alpha, RGB and RGBA: the port reads what PIL reads."""
    h, w = 23, 37
    rng = np.random.RandomState(10 + c)
    img = np.stack([_image(h, w, 1, seed=c + i) for i in range(c)], -1)
    rows = img.reshape(h, -1)
    prior = np.zeros(rows.shape[1], np.uint8)
    data = b""
    for row, kind in zip(rows, rng.randint(0, 5, h)):
        data += _filtered(row, int(kind), prior, c)
        prior = row
    header = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 2: 4, 3: 2, 4: 6}[c], 0, 0, 0)
    buf = png.SIGNATURE + png._chunk(b"IHDR", header) + png._chunk(b"IDAT", zlib.compress(data)) + png._chunk(
        b"IEND", b"")
    want = np.asarray(Image.open(io.BytesIO(buf)))
    assert np.array_equal(want.reshape(h, w, c), img)
    assert np.array_equal(png.decode_png(buf), want)


def test_writer_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        png.encode_png(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="shape"):
        png.encode_png(np.zeros((4, 4, 2), np.uint8))
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(tmp_path / "deep.png")
    with pytest.raises(ValueError, match="bit depth"):
        png.read_png(str(tmp_path / "deep.png"))

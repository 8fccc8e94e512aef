"""PNG files of 8-bit gray and RGB images, with ``zlib`` and ``struct`` alone.

vfi_tpu writes and reads its PNGs with PIL; the port needs no image library,
so the same code runs wherever the port does.  Pixel values are PIL's in
both directions; the file bytes need not be.

* :func:`write_png` writes 8-bit gray (``[H, W]`` or ``[H, W, 1]``) or RGB
  (``[H, W, 3]``), every row with filter type 0 (None), compressed at zlib
  level 6, PIL's default.
* :func:`read_png` reads 8-bit, non-interlaced gray, gray + alpha, RGB and
  RGBA files, with any of the five filter types per row (PIL picks them
  adaptively), and returns the array ``np.asarray(PIL.Image.open(path))``
  gives: ``[H, W]`` for gray, ``[H, W, C]`` otherwise.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Color type -> channels (8-bit samples): gray, RGB, gray + alpha, RGBA.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
ZLIB_LEVEL = 6


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def encode_png(img: np.ndarray) -> bytes:
    """The PNG file of a uint8 image ``[H, W]``, ``[H, W, 1]`` or ``[H, W, 3]``."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8 images, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"PNG writer takes [H, W], [H, W, 1] or [H, W, 3] images, got shape {img.shape}")
    h, w = img.shape[:2]
    raw = np.zeros((h, 1 + img[0].size), np.uint8)  # a leading 0 per row: filter type None
    raw[:, 1:] = img.reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return b"".join((SIGNATURE, _chunk(b"IHDR", header), _chunk(b"IDAT", zlib.compress(raw.tobytes(), ZLIB_LEVEL)),
                     _chunk(b"IEND", b"")))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _unfilter_sequential(kind: int, line: bytearray, prior: bytes, bpp: int) -> bytearray:
    """Average (3) and Paeth (4) rows, each byte after its left neighbour."""
    out = bytearray(line)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The image bytes ``[h, stride]`` of decompressed IDAT data."""
    rows = np.frombuffer(data, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    kinds, lines = rows[:, 0], rows[:, 1:]
    if not kinds.any():  # every row None: the writer's own files
        return lines.copy()
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(kinds[y]), lines[y]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum mod 256 of each byte of a pixel
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint32) & 0xFF).astype(np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):
            cur = np.frombuffer(_unfilter_sequential(kind, bytearray(line.tobytes()), prior.tobytes(), bpp),
                                np.uint8)
        else:
            raise ValueError(f"PNG row {y} has unknown filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(buf: bytes) -> np.ndarray:
    """The image of a PNG file's bytes (see :func:`read_png`)."""
    if buf[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos : pos + 4])
        tag, data = buf[pos + 4 : pos + 8], buf[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG file without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"PNG reader takes 8-bit non-interlaced gray/RGB(A) files; got bit depth {depth}, "
                         f"color type {color}, interlace {interlace}")
    ch = _CHANNELS[color]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch).reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def read_png(path: str) -> np.ndarray:
    """uint8 ``[H, W]`` (gray) or ``[H, W, C]`` (gray + alpha, RGB, RGBA), as PIL reads the file."""
    with open(path, "rb") as f:
        return decode_png(f.read())

#!/usr/bin/env python3
"""Host time of the port's PNG reader (``vfi_tpu_torch/utils/png.py``) on
frames filtered as an adaptive encoder (PIL, libpng) files them.

    python3 scripts/time_png_decode.py

Builds a 240x320 RGB frame (the UCF-101 / HMDB-51 size) and a 128x128 gray
one (KTH) from seed 0, smooth gradients under noise, and encodes each three
ways: every row filter None (the port's own writer), every row Paeth, and
each row's filter picked by libpng's heuristic (the least sum of the
filtered bytes taken as signed), which is how PIL writes. Each file is
decoded once and checked against its frame, then timed: the median and
the least of 20 decodes, zlib included. One JSON line per file. Needs
numpy alone; runs on any host.
"""

from __future__ import annotations

import json
import os
import platform
import struct
import sys
import time
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vfi_tpu_torch.utils import png  # noqa: E402

REPEATS = 20


def frame(h: int, w: int, c: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    smooth = 128 + 60 * np.sin(xx / 17.0 + yy / 23.0)[..., None] + 30 * np.cos(yy / 11.0)[..., None] * np.arange(
        1, c + 1)
    return np.clip(smooth + rng.normal(0, 6, (h, w, c)), 0, 255).astype(np.uint8)


def filter_rows(img: np.ndarray, choice: str) -> tuple[bytes, list]:
    """IDAT bytes of ``img`` [H, W, C], every row with filter ``choice``
    ("none", "paeth") or the adaptive pick ("adaptive"); returns the filter
    counts [None, Sub, Up, Average, Paeth] beside them."""
    h, w, c = img.shape
    raw = img.reshape(h, w * c).astype(np.int16)
    a = np.zeros_like(raw)
    a[:, c:] = raw[:, :-c]
    b = np.zeros_like(raw)
    b[1:] = raw[:-1]
    cc = np.zeros_like(raw)
    cc[:, c:] = b[:, :-c]
    pa, pb, pc = np.abs(b - cc), np.abs(a - cc), np.abs(a + b - 2 * cc)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    filtered = np.stack([raw, raw - a, raw - b, raw - ((a + b) >> 1), raw - paeth]) & 0xFF  # [5, H, W*C]
    if choice == "none":
        kinds = np.zeros(h, np.int64)
    elif choice == "paeth":
        kinds = np.full(h, 4)
    else:
        signed = np.where(filtered > 127, 256 - filtered, filtered)
        kinds = signed.sum(-1).argmin(0)
    rows = np.concatenate([kinds[:, None], filtered[kinds, np.arange(h)]], 1).astype(np.uint8)
    return rows.tobytes(), np.bincount(kinds, minlength=5).tolist()


def png_file(img: np.ndarray, idat: bytes) -> bytes:
    h, w, c = img.shape
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if c == 1 else 2, 0, 0, 0)
    return b"".join((png.SIGNATURE, png._chunk(b"IHDR", header), png._chunk(b"IDAT", zlib.compress(idat, 6)),
                     png._chunk(b"IEND", b"")))


def main() -> None:
    for name, (h, w, c) in (("rgb_240x320", (240, 320, 3)), ("gray_128x128", (128, 128, 1))):
        img = frame(h, w, c, seed=0)
        for choice in ("none", "paeth", "adaptive"):
            idat, counts = filter_rows(img, choice)
            buf = png_file(img, idat)
            got = png.decode_png(buf)
            if not np.array_equal(got.reshape(h, w, c), img):
                raise SystemExit(f"{name} {choice}: the decoded frame differs from the encoded one")
            times = []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                png.decode_png(buf)
                times.append(time.perf_counter() - t0)
            print(json.dumps({"frame": name, "filters": choice, "filter_counts": counts, "bytes": len(buf),
                              "decode_ms_median": 1e3 * float(np.median(times)),
                              "decode_ms_min": 1e3 * min(times), "repeats": REPEATS, "host": platform.node(),
                              "cpu": platform.processor() or platform.machine()}), flush=True)


if __name__ == "__main__":
    main()

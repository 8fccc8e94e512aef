"""ctypes bindings for the native C++ clip loader (counterpart of
``vfi_tpu/data/native_loader.py``; source ``csrc/vfidata.cpp``).

Host decoding, not a device path.  The shared library is built with g++
against libpng and libjpeg at first use, into ``vfi_tpu_torch/_build/``
(named by a hash of the source).  Where g++, libpng or libjpeg is missing,
:func:`available` is false and callers keep the pure-Python path
(``datasets.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "vfidata.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
LIBS = ("-lpng", "-ljpeg", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libvfidata-{digest}.so"


def _build(lib: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Built under a temporary name and renamed into place, so that processes
    # building at once never load half a file.
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), *LIBS, "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"vfidata build failed: {e}")
        return False
    if r.returncode != 0:
        print(f"vfidata build failed:\n{r.stderr}")
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, lib)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        path = library_path()
        if not path.is_file() and not _build(path):
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            print(f"vfidata load failed: {e}")
            _failed = True
            return None
        lib.vfid_load_clip_batch.restype = ctypes.c_int
        lib.vfid_load_clip_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def load_clip_batch(
    frame_paths: Sequence[Sequence[str]],
    image_size: Sequence[int],
    c_dim: int,
    padding_size: Sequence[int] = (0, 0),
    flip_flags: Optional[Sequence[bool]] = None,
    reverse_flags: Optional[Sequence[bool]] = None,
    n_threads: int = 0,
) -> np.ndarray:
    """Decode + preprocess B clips of T frame files into one float32 batch.

    :param frame_paths: B lists of T file paths (PNG/JPEG)
    :return: [B, T, H+pad_b, W+pad_r, c_dim] float32 in [-1, 1] (BGR order)
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    B = len(frame_paths)
    T = len(frame_paths[0])
    H, W = image_size
    pb, pr = padding_size
    flat: List[bytes] = [p.encode() for clip in frame_paths for p in clip]
    arr = (ctypes.c_char_p * (B * T))(*flat)
    flips = np.asarray(flip_flags if flip_flags is not None else [0] * B, np.uint8)
    revs = np.asarray(reverse_flags if reverse_flags is not None else [0] * B, np.uint8)
    out = np.empty((B, T, H + pb, W + pr, c_dim), np.float32)
    failures = lib.vfid_load_clip_batch(
        arr, B, T, H, W, c_dim, pb, pr,
        flips.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        revs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_threads,
    )
    if failures:
        raise IOError(f"native loader failed to decode {failures} frame(s)")
    return out

"""Build and bind the port's hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes``.  Libraries go to
``vfi_tpu_torch/_build/``, named by a hash of the source and the flags, and
are built at first use (or by :func:`build_all`).  Importing this module builds
and loads nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# --split-compile=0 optimizes a source's kernels in parallel (the int8 conv
# instantiates 20: 5 N tiles x 4 kernel sizes).  No source needs a link flag:
# the int8 conv's weight copies are cp.async.bulk, which takes no tensor map.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0")
SOURCES = {
    "sepconv_fwd": "sepconv_fwd.cu",
    "sepconv_fwd_mxu": "sepconv_fwd_mxu.cu",
    "sepconv_bwd_vh": "sepconv_bwd_vh.cu",
    "sepconv_bwd_x": "sepconv_bwd_x.cu",
    "qconv_int8": "qconv_int8.cu",
}
# Headers hashed into every library's name, so that an edit rebuilds it
# (qconv_int8.cu includes none of them).
HEADERS = ("sepconv_common.cuh", "sepconv_mma.cuh")

# The sepconv kernels are instantiated for 1..4 channels (one f32 accumulator
# each in registers); ks up to 64 keeps each kernel's shared-memory tiles
# within a block's 227 KB at C=4, except the float32 tiles with 4 channels
# of the banded forward (which takes them up to ks=54, at 4 rows a block and
# one staging buffer) and of bwd_vh (which raises at ks=51).
SEPCONV_MAX_CHANNELS = 4
SEPCONV_MAX_KS = 64

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the CUDA kernels cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    src = b"".join((CSRC / f).read_bytes() for f in (SOURCES[name], *HEADERS))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=None) -> dict[str, float]:
    """Compile every named source not yet built, all ``nvcc`` processes at once.

    Returns the seconds each build took (0.0 where the library existed).  The
    compiler's report (registers, shared memory, spills) is kept beside each
    library as ``.log``.
    """
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {n: 0.0 for n in names}
    procs = {}
    t0 = time.perf_counter()
    for n in names:
        lib = library_path(n)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, lib)
    failed = []
    for n, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        lib.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    return library_path(name).with_suffix(".log").read_text(errors="replace")


def _load(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build_all([name])
        _libs[name] = ctypes.CDLL(str(library_path(name)))
    return _libs[name]


# Each kernel's C entry takes its rank-4 tensors' pointers, then their
# element strides, then B, H, W, C, ks, the dtype code and the stream.
_N_TENSORS = {"sepconv_fwd": 4, "sepconv_fwd_mxu": 4, "sepconv_bwd_vh": 6, "sepconv_bwd_x": 4}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _entry(name: str):
    lib = _load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        n = _N_TENSORS[name]
        fn.argtypes = [P] * n + [I64] * (4 * n) + [I] * 6 + [P]
        fn.restype = I
        lib.sepconv_error_string.argtypes = [I]
        lib.sepconv_error_string.restype = ctypes.c_char_p
    return lib, fn


def launch(name: str, tensors, B: int, H: int, W: int, C: int, ks: int) -> None:
    """Launch kernel ``name`` on the current stream over rank-4 ``tensors``
    (inputs then outputs, already checked by the wrapper); raises on a
    non-zero CUDA error."""
    lib, fn = _entry(name)
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    strides = [s for t in tensors for s in t.stride()]
    rc = fn(*(t.data_ptr() for t in tensors), *strides, B, H, W, C, ks, _DTYPE_CODE[tensors[0].dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({lib.sepconv_error_string(rc).decode()})")


# Argument types of the int8 conv library's C entry (csrc/qconv_int8.cu):
# x, x_scale, packed weights, scale, bias, out; x's four element strides;
# N, C, H, W, Co, k, the N tile, the two dtype codes; the stream.
_QCONV_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def qconv_launch(*args) -> None:
    """Call the int8 conv library's ``qconv_int8`` (pointers and sizes
    already checked by the wrapper in ``ops/qconv.py``) on the current
    stream; raises on a non-zero CUDA error."""
    lib = _load("qconv_int8")
    fn = lib.qconv_int8
    if fn.argtypes is None:
        fn.argtypes = _QCONV_ARGTYPES
        fn.restype = ctypes.c_int
        lib.qconv_error_string.argtypes = [ctypes.c_int]
        lib.qconv_error_string.restype = ctypes.c_char_p
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qconv_int8 launch failed: CUDA error {rc} ({lib.qconv_error_string(rc).decode()})")

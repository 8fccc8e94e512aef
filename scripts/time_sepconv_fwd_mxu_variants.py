#!/usr/bin/env python3
"""Time build-time variants of the banded sepconv forward kernel on one GPU.

    python3 scripts/time_sepconv_fwd_mxu_variants.py [variant ...]

Each variant is ``vfi_tpu_torch/ops/csrc/sepconv_fwd_mxu.cu`` with a few
lines replaced (``VARIANTS`` below), built by nvcc with the port's flags into
``vfi_tpu_torch/_build/variants/`` and launched through its C entry.  Two
variants take work away to show where the time goes: ``no_products`` skips
the tensor-core products (the staging, barriers and tap reduction remain),
``stage_once`` stages h and v for the first row only (the slab, the products
and the reduction remain).  Their outputs are wrong by design; the others are
checked against ``sepconv_banded`` on 8 images.  Each is timed twice, in
turns, at the serving shapes (TAI_gray B*T=320 128x128 C=1, TAI_color B*T=80
256x320 C=3, ks=51) in bf16 and f32, beside the direct kernel.  One JSON line
per shape and dtype; the card's name and power limit last.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from vfi_tpu_torch.ops import _kernels  # noqa: E402
from vfi_tpu_torch.ops import sepconv as sepconv_ops  # noqa: E402

STAGING_DEPTH = "constexpr int U = SPLIT ? 16 : 4;"
WARPS = "constexpr int WARPS = 16;"
VARIANTS = {
    "as_built": [],
    "u1": [(STAGING_DEPTH, "constexpr int U = 1;")],
    "u4": [(STAGING_DEPTH, "constexpr int U = 4;")],
    "u8": [(STAGING_DEPTH, "constexpr int U = 8;")],
    "u16": [(STAGING_DEPTH, "constexpr int U = 16;")],
    "warps8": [(WARPS, "constexpr int WARPS = 8;")],
    "no_products": [("mma_bf16(acc[mt],", "if (ks < 0) mma_bf16(acc[mt],")],
    "stage_once": [("for (int base = tid; base < n_band; base += U * THREADS) {",
                    "for (int base = tid; yy == 0 && base < n_band; base += U * THREADS) {")],
}
WRONG_BY_DESIGN = ("no_products", "stage_once")


def build(names):
    out_dir = _kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_kernels.CSRC / _kernels.SOURCES["sepconv_fwd_mxu"]).read_text()
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in the kernel source")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{name}.so"
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", str(_kernels.CSRC), "-o", str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib)
    entries = {}
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} failed to build:\n{log.decode(errors='replace')}")
        fn = ctypes.CDLL(str(lib)).sepconv_fwd_mxu
        fn.argtypes = [P] * 4 + [I64] * 16 + [I] * 6 + [P]
        fn.restype = I
        regs = [ln.strip() for ln in log.decode().splitlines() if "registers" in ln]
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
        entries[name] = fn
    return entries


def launch(fn, x, v, h):
    B, H, W, ks = v.shape
    out = torch.empty((B, H, W, x.shape[-1]), dtype=x.dtype, device=x.device)
    ts = (x, v, h, out)
    rc = fn(*(t.data_ptr() for t in ts), *(s for t in ts for s in t.stride()), B, H, W, x.shape[-1], ks,
            _kernels._DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise SystemExit(f"launch failed: CUDA error {rc}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(VARIANTS)
    torch.backends.cuda.matmul.allow_tf32 = False
    entries = build(names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for BT, H, W, C in ((320, 128, 128, 1), (80, 256, 320, 3)):
        for dtype in (torch.bfloat16, torch.float32):
            x, v, h = chip_smoke.sepconv_operands(BT, H, W, C, chip_smoke.KS, dtype, gen)
            ref = sepconv_ops.sepconv_banded(*(t[:8].float() for t in (x, v, h)))
            line = {"shape": [BT, H, W, C, chip_smoke.KS], "dtype": str(dtype),
                    "direct_ms": chip_smoke.cuda_ms(lambda: sepconv_ops.sepconv_fwd_cuda(x, v, h), iters=10)}
            for _ in range(2):
                for name, fn in entries.items():
                    line.setdefault(f"{name}_ms", []).append(chip_smoke.cuda_ms(lambda: launch(fn, x, v, h), iters=10))
            for name, fn in entries.items():
                if name not in WRONG_BY_DESIGN:
                    err = float((launch(fn, x[:8], v[:8], h[:8]).float() - ref).abs().max())
                    line[f"{name}_max_abs_err"] = err
            print(json.dumps(line), flush=True)
            del x, v, h, ref
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

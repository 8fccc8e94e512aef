#!/usr/bin/env python3
"""Time build-time variants of the two sepconv forward kernels on one GPU.

    python3 scripts/time_sepconv_fwd_mxu_variants.py [--baseline CHECKOUT] [variant ...]

Each variant is ``vfi_tpu_torch/ops/csrc/sepconv_fwd_mxu.cu`` (the banded
kernel) or ``sepconv_fwd.cu`` (the direct one), or a header they include,
with a few lines replaced (``VARIANTS`` below), built by nvcc with the port's
flags (all at once, ``chip_smoke.build_variants``) and launched through its
C entry.  Banded: ``no_products`` skips the tensor-core products (staging,
barriers and the tap reduction remain), ``stage_once`` stages h and v for the
first rows only (the slab, products and reduction remain), ``no_overlap``
waits for each row's copies right after issuing them, ``one_buffer`` takes
one staging buffer and two barriers per row everywhere,
``buffers_first`` prefers two buffers with one block per SM to two blocks
with one buffer where both do not fit (bf16 with three channels), and
``one_block`` lets bf16 take 128 registers a thread (one block per SM).
Direct: ``p2`` owns 2 output rows per thread, ``j13`` takes the taps in
chunks of 13, ``d4`` keeps 4 rows of v in flight per warp (not 8), ``no_full_rows``
checks every row's tap rows, ``scalar_v``
stages v by scalar loads instead of cp.async, ``direct_one_block`` lets
every channel count take 255 registers a thread (one block per SM).
Outputs are wrong by design where work is taken away; the others are checked
against the plain version on 2 images.  ``--baseline`` adds the two forward
kernels of another checkout of this repo (an earlier commit).  All are timed
twice, in turns, at the serving shapes (TAI_gray B*T=320 128x128 C=1,
TAI_color B*T=80 256x320 C=3, ks=51) in bf16 and f32.  One JSON line per
kernel, shape and dtype; the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke  # noqa: E402

MMA = "sepconv_mma.cuh"
VARIANTS = {  # kernel -> variant -> [(file, old, new)]
    "sepconv_fwd_mxu": {
        "as_built": [],
        "no_products": [(MMA, "mma_bf16(acc[mt],", "if (ks < 0) mma_bf16(acc[mt],")],
        "stage_once": [("kernel", "    const int y = y0 + yy;\n    T* hb = bufs",
                        "    if (yy > 1) return sepconv::cp_async_commit();\n    const int y = y0 + yy;\n"
                        "    T* hb = bufs")],
        "no_overlap": [("kernel", "stage(yy + 1, cur ^ 1);", "stage(yy + 1, cur ^ 1); sepconv::cp_async_wait_all();")],
        "one_buffer": [("kernel", "CONFIGS[][2] = {{16, 2}, {8, 2}, ", "CONFIGS[][2] = {")],
        "buffers_first": [("kernel", "return min_blocks<T>() == 2;", "return false;")],
        "one_block": [("kernel", "return sizeof(T) == 2 ? 2 : 1;", "return 1;")],
    },
    "sepconv_fwd": {
        "as_built": [],
        "p2": [("kernel", "constexpr int P = 4;", "constexpr int P = 2;")],
        "j13": [("kernel", "constexpr int J = 17;", "constexpr int J = 13;")],
        "d4": [("kernel", "constexpr int D = 8;", "constexpr int D = 4;")],
        "no_full_rows": [("kernel", "row(r, std::true_type{});", "row(r, std::false_type{});")],
        "scalar_v": [("kernel", "const bool s_async = v_async", "const bool s_async = ks < 0")],
        "direct_one_block": [("kernel", "return C % 2 == 1 ? 2 : 1;", "return 1;")],
    },
}
WRONG_BY_DESIGN = ("no_products", "stage_once")
PLAIN = {"sepconv_fwd_mxu": "sepconv_banded", "sepconv_fwd": "sepconv_direct"}
SHAPES = {k: chip_smoke.FORWARD_SHAPES[k] for k in ("gray", "color")}


def wrap(fn):
    """A callable with the port wrapper's arguments around a variant's C entry."""
    def run(x, v, h):
        out = torch.empty((*v.shape[:3], x.shape[-1]), dtype=x.dtype, device=x.device)
        chip_smoke.call_library(fn, (x, v, h, out), *v.shape[:3], x.shape[-1], v.shape[-1])
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", metavar="CHECKOUT", help="another checkout whose two forward kernels are timed too")
    ap.add_argument("variants", nargs="*", help="variant names (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    wanted = {(k, n): p for k, vs in VARIANTS.items() for n, p in vs.items()
              if not args.variants or n in args.variants}
    runs = {}
    for key, (fn, ptxas) in chip_smoke.build_variants(wanted).items():
        print(json.dumps({"kernel": key[0], "variant": key[1], "ptxas": ptxas}), flush=True)
        runs[key] = wrap(fn)
    if args.baseline:
        base = chip_smoke.baseline_kernels(os.path.abspath(args.baseline))
        for kernel in VARIANTS:
            runs[kernel, "baseline"] = base[kernel]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for BT, H, W, C in SHAPES.values():
        for dtype in (torch.bfloat16, torch.float32):
            x, v, h = chip_smoke.sepconv_operands(BT, H, W, C, chip_smoke.KS, dtype, gen)
            for kernel in VARIANTS:
                ref = getattr(chip_smoke.sepconv_ops, PLAIN[kernel])(*(t[:2].float() for t in (x, v, h)))
                line = {"kernel": kernel, "shape": [BT, H, W, C, chip_smoke.KS], "dtype": str(dtype)}
                mine = {n: fn for (k, n), fn in runs.items() if k == kernel}
                for _ in range(2):
                    for name, fn in mine.items():
                        line.setdefault(f"{name}_ms", []).append(chip_smoke.cuda_ms(lambda: fn(x, v, h), iters=10))
                for name, fn in mine.items():
                    if name not in WRONG_BY_DESIGN:
                        line[f"{name}_max_abs_err"] = float((fn(x[:2], v[:2], h[:2]).float() - ref).abs().max())
                print(json.dumps(line), flush=True)
                del ref
            del x, v, h
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

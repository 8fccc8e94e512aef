#!/usr/bin/env python3
"""Time build-time variants of the two sepconv adjoint kernels on one GPU.

    python3 scripts/time_sepconv_adjoint_variants.py [--baseline CHECKOUT] [variant ...]

Each variant is ``vfi_tpu_torch/ops/csrc/sepconv_bwd_vh.cu`` or
``sepconv_bwd_x.cu`` with a few lines replaced (``VARIANTS`` below), built by
nvcc with the port's flags into ``vfi_tpu_torch/_build/variants/`` (all at
once, ``chip_smoke.build_variants``) and launched through its C entry.  Variants that take work away show
where the time goes: ``no_products`` skips the tensor-core products (the
staging, barriers and epilogues remain), ``stage_once`` stages the first
rows only (the slab, products and epilogues remain); ``no_overlap`` waits for
each row's copies right after issuing them, so staging and products no
longer overlap; ``one_buffer`` (``bwd_vh``) takes its single-buffer path
with two barriers per row; ``ts32`` (``bwd_x``) takes input tiles of 32
rows.  Their outputs are wrong by design where work is taken away; the others
are checked against the plain adjoints on 2 images.  ``--baseline`` adds the
same two kernels of another checkout of this repo (an earlier commit).  All
are timed twice, in turns, at the training shapes (TAI_gray B*T=40 128x128
C=1, TAI_color B*T=20 256x320 C=3, ks=51) in bf16 and f32.  One JSON line per
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
from vfi_tpu_torch.ops import sepconv as sepconv_ops  # noqa: E402

VH_STAGE = "if (yy + 1 < n_rows) stage(yy + 1, (yy + 1) & 1);"
X_STAGE = "if (y < yhi) stage(y + 1, cur ^ 1);"
VARIANTS = {  # kernel -> variant -> [(old, new)]
    "sepconv_bwd_vh": {
        "as_built": [],
        "no_products": [("mma_bf16(acc, a", "if (ks < 0) mma_bf16(acc, a"),
                        ("mma_bf16(acc[mt],", "if (ks < 0) mma_bf16(acc[mt],")],
        "stage_once": [("    const int y = y0 + yy;\n    sepconv::stage_rows",
                        "    if (yy > 1) return sepconv::cp_async_commit();\n    const int y = y0 + yy;\n"
                        "    sepconv::stage_rows")],
        "no_overlap": [(VH_STAGE, VH_STAGE + " sepconv::cp_async_wait_all();")],
        "one_buffer": [("for (int nbuf : {2, 1}) {", "for (int nbuf : {1}) {")],
    },
    "sepconv_bwd_x": {
        "as_built": [],
        "no_products": [("mma_bf16(d,", "if (ks < 0) mma_bf16(d,")],
        "stage_once": [("    T* vb = bufs + i * buf_elems;\n    T* hb",
                        "    if (y > ylo + 1) return sepconv::cp_async_commit();\n    T* vb = bufs + i * buf_elems;\n"
                        "    T* hb")],
        "no_overlap": [(X_STAGE, X_STAGE + " sepconv::cp_async_wait_all();")],
        "ts32": [("constexpr int TS = 64;", "constexpr int TS = 32;")],
    },
}
WRONG_BY_DESIGN = ("no_products", "stage_once")
# Patches whose text lives in a shared header: bwd_vh's grad_v products are
# the forward's horizontal pass in sepconv_mma.cuh.
HEADER_PATCHES = {"mma_bf16(acc[mt],": "sepconv_mma.cuh"}


def build(wanted):
    """Build every (kernel, variant) in ``wanted`` at once; returns their C entries."""
    patches = {(k, n): [(HEADER_PATCHES.get(old, "kernel"), old, new) for old, new in VARIANTS[k][n]]
               for k, n in wanted}
    entries = {}
    for key, (fn, ptxas) in chip_smoke.build_variants(patches).items():
        print(json.dumps({"kernel": key[0], "variant": key[1], "ptxas": ptxas}), flush=True)
        entries[key] = fn
    return entries


def wrap(kernel, fn):
    """A callable with the port wrapper's arguments around a variant's C entry."""
    if kernel == "sepconv_bwd_vh":
        def run(x, v, h, g):
            gv, gh = torch.empty_like(v), torch.empty_like(h)
            chip_smoke.call_library(fn, (x, v, h, g, gv, gh), *v.shape[:3], x.shape[-1], v.shape[-1])
            return gv, gh
    else:
        def run(x, v, h, g):
            B, H, W, ks = v.shape
            gx = torch.empty((B, H + ks - 1, W + ks - 1, g.shape[-1]), dtype=g.dtype, device=g.device)
            chip_smoke.call_library(fn, (v, h, g, gx), B, H, W, g.shape[-1], ks)
            return (gx,)
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", metavar="CHECKOUT", help="another checkout whose two adjoint kernels are timed too")
    ap.add_argument("variants", nargs="*", help="variant names (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    wanted = [(k, n) for k, vs in VARIANTS.items() for n in vs if not args.variants or n in args.variants]
    runs = {key: wrap(key[0], fn) for key, fn in build(wanted).items()}
    if args.baseline:
        base = chip_smoke.baseline_kernels(os.path.abspath(args.baseline))
        runs["sepconv_bwd_vh", "baseline"] = base["sepconv_bwd_vh"]
        runs["sepconv_bwd_x", "baseline"] = lambda x, v, h, g: (base["sepconv_bwd_x"](v, h, g),)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for BT, H, W, C in chip_smoke.ADJOINT_SHAPES.values():
        for dtype in (torch.bfloat16, torch.float32):
            x, v, h, g = chip_smoke._adjoint_cases(BT, H, W, C, chip_smoke.KS, dtype, gen)
            wide = [t[:2].float() for t in (x, v, h, g)]
            ref = {"sepconv_bwd_vh": sepconv_ops.sepconv_bwd_vh_plain(*wide),
                   "sepconv_bwd_x": (sepconv_ops.sepconv_bwd_x_plain(*wide[1:]),)}
            for kernel in VARIANTS:
                line = {"kernel": kernel, "shape": [BT, H, W, C, chip_smoke.KS], "dtype": str(dtype)}
                mine = {n: fn for (k, n), fn in runs.items() if k == kernel}
                for _ in range(2):
                    for name, fn in mine.items():
                        line.setdefault(f"{name}_ms", []).append(
                            chip_smoke.cuda_ms(lambda: fn(x, v, h, g), iters=10))
                for name, fn in mine.items():
                    if name not in WRONG_BY_DESIGN:
                        got = fn(*(t[:2] for t in (x, v, h, g)))
                        err = max(float((a.float() - b).abs().max()) for a, b in zip(got, ref[kernel]))
                        line[f"{name}_max_abs_err"] = err
                print(json.dumps(line), flush=True)
            del x, v, h, g, wide, ref
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

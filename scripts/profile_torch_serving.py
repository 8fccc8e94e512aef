#!/usr/bin/env python3
"""Where the port's bi-TAI serving forward spends its time on one NVIDIA GPU.

    python3 scripts/profile_torch_serving.py

Runs ``vfi_tpu_torch.api.VideoInpainter("TAI_gray")`` (random weights from
seed 0; TF32 off) at B=8 and B=64 in bf16 and f32, and prints one JSON line
per run with

  * ``layers_ms``: device time of each layer of the forward, from CUDA events
    recorded by forward hooks (and around each sepconv call), summed over its
    calls in one forward;
  * ``kernels_ms``: device time by kernel category over one forward, from
    ``torch.profiler``, with the top kernels by name;
  * ``device_busy_share``: the union of the kernels' device intervals over
    the host wall time of the profiled forwards.

First it prints the forward's convolution and matrix-product FLOPs by layer
at each batch size, counted by ``FlopCounterMode`` on the meta device (no
GPU needed for that line; sepconv is left out of the count).  The rest
needs CUDA.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vfi_tpu_torch.api import VideoInpainter  # noqa: E402
from vfi_tpu_torch.models.registry import create_model  # noqa: E402
from vfi_tpu_torch.nn import kernelnet as kernelnet_mod  # noqa: E402
from vfi_tpu_torch.ops import _kernels  # noqa: E402
from vfi_tpu_torch.utils.params import params_from_jax, random_jax_params  # noqa: E402

LAYERS = ("mcnet", "mcnet.motion_enc", "mcnet.content_enc", "mcnet.conv_lstm", "mcnet.comb_layers",
          "mcnet.residual1", "mcnet.residual2", "mcnet.residual3", "mcnet.dec_cnn",
          "merge_residual2", "merge_residual3", "kernelnet", "kernelnet.vertical1", "kernelnet.vertical2",
          "kernelnet.horizontal1", "kernelnet.horizontal2")
# First match wins; cuDNN's and cuBLAS's conv kernels carry these words in their names.
CATEGORIES = (
    ("sepconv_fwd", r"sepconv_fwd"),
    ("layout_transform", r"nchwToNhwc|nhwcToNchw|[Tt]ranspose"),
    ("conv", r"conv|gemm|xmma|cudnn|implicit|cutlass|winograd|fft|sm90_|sm80_"),
    ("pool", r"pool"),
    ("upsample", r"upsample"),
    ("cat_copy", r"CatArray|[Cc]opy"),
    ("reduce", r"reduce"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
)
T, K, H, W = 5, 5, 128, 128


class LayerTimer:
    """CUDA events around every call of the named submodules and of sepconv."""

    def __init__(self, model):
        self.spans: dict[str, list] = {}
        self.handles = []
        for name in LAYERS:
            mod = model.get_submodule(name)
            self.handles.append(mod.register_forward_pre_hook(lambda m, a, n=name: self._start(n)))
            self.handles.append(mod.register_forward_hook(lambda m, a, o, n=name: self._stop(n)))
        self._sepconv = kernelnet_mod.sepconv

        def timed(*args, **kw):
            self._start("kernelnet.sepconv")
            out = self._sepconv(*args, **kw)
            self._stop("kernelnet.sepconv")
            return out

        kernelnet_mod.sepconv = timed

    def _start(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.spans.setdefault(name, []).append([ev, None])

    def _stop(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.spans[name][-1][1] = ev

    def close(self) -> dict[str, float]:
        torch.cuda.synchronize()
        for h in self.handles:
            h.remove()
        kernelnet_mod.sepconv = self._sepconv
        return {n: sum(a.elapsed_time(b) for a, b in s) for n, s in self.spans.items()}


def forward_flops(B: int) -> dict[str, float]:
    """Convolution and matrix-product FLOPs of one TAI_gray forward, by layer."""
    with torch.device("meta"):
        model = create_model("TAI_gray")
        frames = torch.empty(B, K, H, W, 1)
    saved = kernelnet_mod.sepconv
    kernelnet_mod.sepconv = lambda x, v, h, impl=None: torch.empty(v.shape[:3] + x.shape[-1:], device="meta")
    try:
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            model(T, frames, frames)
    finally:
        kernelnet_mod.sepconv = saved
    counts = counter.get_flop_counts()
    layers = ("mcnet", "merge_residual2", "merge_residual3", "kernelnet")
    return {"total": counter.get_total_flops(),
            **{n: sum(counts[f"{type(model).__name__}.{n}"].values()) for n in layers}}


def category(kernel_name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, kernel_name):
            return cat
    return "other"


def profile_run(ip: VideoInpainter, B: int, dtype: torch.dtype, gen: torch.Generator, iters: int = 3) -> dict:
    p = (torch.rand(B, K, H, W, 1, device="cuda", generator=gen) * 2 - 1).to(dtype)
    f = (torch.rand(B, K, H, W, 1, device="cuda", generator=gen) * 2 - 1).to(dtype)
    for _ in range(2):
        ip.forward(T, p, f)
    torch.cuda.synchronize()

    timer = LayerTimer(ip.model)
    ip.forward(T, p, f)
    layers = timer.close()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            ip.forward(T, p, f)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_cat: dict[str, float] = {}
    by_name: dict[str, float] = {}
    intervals = []
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_cat[category(e.name)] = by_cat.get(category(e.name), 0.0) + us / 1e3 / iters
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3 / iters
        intervals.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "batch": B, "dtype": str(dtype).replace("torch.", ""), "T": T,
        "forward_ms_host": wall_us / 1e3 / iters,
        "layers_ms": layers,
        "kernels_ms": by_cat if kernels else "not measured (the profiler saw no device kernels)",
        "kernel_launches_per_forward": len(kernels) / iters,
        "device_busy_share": busy / wall_us if kernels else "not measured",
        "top_kernels_ms": [[name[:120], ms] for name, ms in top],
    }


def main() -> int:
    print(json.dumps({"flops_per_forward": {B: forward_flops(B) for B in (8, 64)}}), flush=True)
    if not torch.cuda.is_available():
        print("profile_torch_serving: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "torch": torch.__version__}),
          flush=True)
    _kernels.build_all()
    state = params_from_jax(random_jax_params("TAI_gray", 0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        ip = VideoInpainter("TAI_gray", state, device="cuda", dtype=dtype)
        for B in (8, 64):
            print(json.dumps(profile_run(ip, B, dtype, gen)), flush=True)
        del ip
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

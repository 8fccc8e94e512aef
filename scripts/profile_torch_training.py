#!/usr/bin/env python3
"""Where the port's bi-TAI training step spends its time on one NVIDIA GPU.

    python3 scripts/profile_torch_training.py

Runs ``vfi_tpu_torch.train.environments`` on TAI_gray (random weights from
seed 0; TrainConfig defaults; B=8, K=F=T=5; TF32 off) in bf16 mixed precision
and in f32, and prints one JSON line per run with

  * ``g_update_ms`` / ``d_update_ms``: host clock around each update, each
    ended by a synchronise (median of 3);
  * ``kernels_ms``: device time by kernel category per step, from
    ``torch.profiler`` over 3 steps, with the top kernels by name;
  * ``device_busy_share``: the union of the kernels' device intervals over
    the host wall time of the profiled steps.

Then one ``max_pool2_ab`` line: the bf16 serving forward at B=64 and the
training step at B=8 in both dtypes, with ``max_pool2``'s tie-splitting
autograd Function (forward ``F.max_pool2d``) against reshape + ``amax`` (the
same gradient), in turns: function, amax, amax, function.  Needs CUDA;
imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import profile_torch_serving as serving  # noqa: E402
from vfi_tpu_torch.api import VideoInpainter  # noqa: E402
from vfi_tpu_torch.models.registry import create_model  # noqa: E402
from vfi_tpu_torch.nn import layers, mcnet  # noqa: E402
from vfi_tpu_torch.ops import _kernels  # noqa: E402
from vfi_tpu_torch.train.environments import create_training_environment  # noqa: E402
from vfi_tpu_torch.utils.config import TrainConfig  # noqa: E402
from vfi_tpu_torch.utils.params import params_from_jax, random_jax_params  # noqa: E402

B, K, T, F, H, W = 8, 5, 5, 5, 128, 128
CATEGORIES = (
    ("sepconv_bwd_vh", r"sepconv_bwd_vh"),
    ("sepconv_bwd_x", r"sepconv_bwd_x"),
    ("adam", r"multi_tensor|[Ff]oreach"),
    *serving.CATEGORIES,
)


def category(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name):
            return cat
    return "other"


def _setup(dtype: str, gen: torch.Generator):
    env = create_training_environment(create_model("TAI_gray"), TrainConfig(K=K, T=T, F=F, train_dtype=dtype))
    targets = torch.rand(B, K + T + F, H, W, 1, device="cuda", generator=gen) * 2 - 1
    state = env.init_state((H, W), g_params=random_jax_params("TAI_gray", 0), device="cuda", seed=1)
    return env, state, targets


def profile_run(dtype: str, gen: torch.Generator, iters: int = 3) -> dict:
    env, state, targets = _setup(dtype, gen)
    for _ in range(3):
        env.train_step(state, K, T, F, targets)
    torch.cuda.synchronize()
    g_ms, d_ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        pred, _ = env._g_update(state, K, T, F, targets)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        env._d_update(state, pred, K, T, F, targets)
        torch.cuda.synchronize()
        g_ms.append((t1 - t0) * 1e3)
        d_ms.append((time.perf_counter() - t1) * 1e3)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            env.train_step(state, K, T, F, targets)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device events minus the profiler's own annotation ranges (the optimizer's step span).
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and not e.name.startswith("Optimizer.")]
    by_cat: dict[str, float] = {}
    by_name: dict[str, float] = {}
    intervals = []
    for e in kernels:
        ms = e.time_range.elapsed_us() / 1e3 / iters
        by_cat[category(e.name)] = by_cat.get(category(e.name), 0.0) + ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        intervals.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "dtype": dtype, "batch": B, "K": K, "T": T, "F": F,
        "g_update_ms": sorted(g_ms)[1], "d_update_ms": sorted(d_ms)[1],
        "step_ms_host_profiled": wall_us / 1e3 / iters,
        "kernels_ms": by_cat if kernels else "not measured (the profiler saw no device kernels)",
        "kernel_launches_per_step": len(kernels) / iters,
        "device_busy_share": busy / wall_us if kernels else "not measured",
        "top_kernels_ms": [[name[:120], ms] for name, ms in top],
    }


def _pool_amax(x: torch.Tensor) -> torch.Tensor:
    B_, C, H_, W_ = x.shape
    return x.reshape(B_, C, H_ // 2, 2, W_ // 2, 2).amax(dim=(3, 5))


def _ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def max_pool2_ab(gen: torch.Generator) -> dict:
    order = ("function", "amax", "amax", "function")
    out = {}
    ip = VideoInpainter("TAI_gray", params_from_jax(random_jax_params("TAI_gray", 0)), device="cuda",
                        dtype=torch.bfloat16)
    p = (torch.rand(64, K, H, W, 1, device="cuda", generator=gen) * 2 - 1).to(torch.bfloat16)
    f = (torch.rand(64, K, H, W, 1, device="cuda", generator=gen) * 2 - 1).to(torch.bfloat16)
    try:
        runs = []
        for name in order:
            mcnet.max_pool2 = layers.max_pool2 if name == "function" else _pool_amax
            runs.append([name, _ms(lambda: ip.forward(T, p, f), 5)])
        out["serve_bf16_b64_ms"] = runs
        del ip, p, f
        torch.cuda.empty_cache()
        for dtype in ("bfloat16", "float32"):
            env, state, targets = _setup(dtype, gen)
            runs = []
            for name in order:
                mcnet.max_pool2 = layers.max_pool2 if name == "function" else _pool_amax
                runs.append([name, _ms(lambda: env.train_step(state, K, T, F, targets), 5)])
            out[f"train_{dtype}_b8_ms_per_step"] = runs
            del env, state, targets
            torch.cuda.empty_cache()
    finally:
        mcnet.max_pool2 = layers.max_pool2
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_training: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "torch": torch.__version__}),
          flush=True)
    _kernels.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in ("bfloat16", "float32"):
        print(json.dumps(profile_run(dtype, gen)), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"max_pool2_ab": max_pool2_ab(gen)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

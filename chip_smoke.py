#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths with random weights from a seed: bi-TAI serving
through ``vfi_tpu_torch.api.VideoInpainter`` and the GAN training step (one G
update, one D update; L2 + GDL + SN-GAN + TAI's intermediate losses, Adam)
through ``vfi_tpu_torch.train.environments``, at two configurations: TAI_gray
(gf=64, ks=51, num_block=5, gray 128x128, K=F=T=5) and TAI_color at the wide
color width (gf=64, ks=51, num_block=4, C=3, 256x320).  The sepconv forward
takes one of two kernels, as vfi_tpu's ``sepconv_impl`` says: the banded
tensor-core kernel by default (``"pallas_mxu"``), the direct kernel under
``"pallas"``.  Phases, one JSON line each:

  1. device      — the card's name and count; fails without CUDA.
  2. build       — compiles every CUDA kernel from ``vfi_tpu_torch/ops/csrc``
                   (four sources), all nvcc processes at once.
  3. kernel      — each kernel against its plain PyTorch version on the card:
                   f32 (TF32 off) within 1e-4 * max(1, max|ref|); bf16 within
                   one bf16 ulp of the f32 plain version on the same bf16
                   inputs.  The banded kernel also against the emulation of
                   its tiling (``_sepconv_mxu_tiled``), recorded.
  4. serve       — TAI_gray, default route: f32 forward on the golden inputs
                   against the JAX golden (``tests/torch_golden_tai_gray.npz``):
                   max-abs <= 5e-3 and uint8 PSNR >= 45 dB; then uint8
                   requests in f32 and bf16; 2 banded and 0 direct launches
                   per forward.
  5. serve_pallas — the same under ``sepconv_impl="pallas"``: 2 direct and 0
                   banded launches per forward.
  6. serve_color — TAI_color at 256x320: f32 against the color golden
                   (``tests/torch_golden_tai_color.npz``: the same gates on
                   what it stores, max-abs at 4096 points of each output and
                   uint8 PSNR of pred's frames), then bf16 uint8 requests at
                   B=16, launches counted.
  7. train_golden — two f32 training steps of TAI_gray at B=2 against the JAX
                   training golden (``tests/torch_golden_train_tai_gray.npz``):
                   loss terms within rel 1e-3, step-1 gradient projections
                   within global-L2-relative 1e-3.
  8. train_kernel_vs_plain — the G gradient through the adjoint kernels
                   against the same gradient through the plain adjoints,
                   global-L2-relative <= 1e-4.
  9. train_pallas — one f32 G update of TAI_gray at B=2 through each forward
                   kernel: G gradients within global-L2-relative 1e-3.
 10. train       — TAI_gray B=8 in bf16 mixed precision and in f32: finite
                   loss terms, 2 launches of the banded forward and of each
                   adjoint per G update, ms per step (G and D updates apart)
                   and peak device memory.
 11. train_color — TAI_color 256x320 B=4 in bf16: the same counts and times.
 12. timing      — CUDA-event times of each kernel, its plain version and the
                   serving forwards; a ``kernels`` line with each kernel's
                   numbers.

Prints the card's name and power limit (nvidia-smi) on the line before the
last, and as the last line ``{"ok": true, "device": {...}}``.  Any failed gate
exits non-zero before that line.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from vfi_tpu_torch.api import VideoInpainter
from vfi_tpu_torch.models.registry import create_model, model_config
from vfi_tpu_torch.ops import _kernels
from vfi_tpu_torch.ops import sepconv as sepconv_ops
from vfi_tpu_torch.train.environments import create_training_environment
from vfi_tpu_torch.utils.config import TrainConfig
from vfi_tpu_torch.utils.params import (disc_variables_from_jax, params_from_jax, random_jax_disc_variables,
                                        random_jax_params)

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_PATH = os.path.join(REPO, "tests", "torch_golden_tai_gray.npz")
# The golden run: the JAX TAIFillInModel on the CPU in f32 (tests/make_torch_golden.py).
GOLDEN = dict(model_key="TAI_gray", param_seed=0, input_seed=1, B=1, K=5, F=5, T=5, H=128, W=128, C=1)
COLOR_GOLDEN_PATH = os.path.join(REPO, "tests", "torch_golden_tai_color.npz")
# The color golden: the JAX TAIFillInModel at TAI_color on the CPU in f32
# (impl "mxu"): pred as uint8 frames, and every output's float values at
# n_points positions drawn with point_seed (tests/make_torch_color_golden.py).
COLOR_GOLDEN = dict(model_key="TAI_color", param_seed=0, input_seed=6, B=1, K=5, F=5, T=3, H=256, W=320, C=3,
                    n_points=4096, point_seed=7)
TRAIN_GOLDEN_PATH = os.path.join(REPO, "tests", "torch_golden_train_tai_gray.npz")
# The training golden: vfi_tpu's TAIEnvironment on the CPU in f32, TrainConfig
# defaults, two train_steps (tests/make_torch_train_golden.py).
TRAIN_GOLDEN = dict(model_key="TAI_gray", param_seed=0, disc_seed=3, input_seed=4, proj_seed=5, B=2, K=5, T=5,
                    F=5, H=128, W=128, C=1, steps=2)
TERM_NAMES = ("G_Lp", "G_gdl", "G_GAN", "G_Lp_forward", "G_Lp_backward", "G_gdl_forward", "G_gdl_backward",
              "G_loss", "D_fake", "D_real")
PRED_KEYS = ("pred", "pred_forward", "pred_backward")
KERNELS = ("sepconv_fwd_mxu", "sepconv_fwd", "sepconv_bwd_vh", "sepconv_bwd_x")
# The two forward kernels: wrapper, plain version, and the line of the TPU
# kernel's pallas_call in vfi_tpu/ops/sepconv.py.
FORWARDS = {
    "sepconv_fwd_mxu": (sepconv_ops.sepconv_fwd_mxu_cuda, sepconv_ops.sepconv_banded, 468),
    "sepconv_fwd": (sepconv_ops.sepconv_fwd_cuda, sepconv_ops.sepconv_direct, 260),
}
# Launches per forward of each forward kernel, by sepconv_impl.
ROUTE_FORWARD = {None: "sepconv_fwd_mxu", "pallas": "sepconv_fwd"}

# Data-sheet peaks (dense): bytes/s of device memory, flop/s for bf16 (tensor
# cores) and f32 (CUDA cores).  Matched on the name torch reports.
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H200": (4.8e12, 989e12, 67e12),
    "H100": (3.35e12, 989e12, 67e12),  # SXM
}
KS = 51


def golden_inputs(cfg=GOLDEN):
    """The golden's preceding and following frames, [B, K|F, H, W, C] in [-1, 1]."""
    rng = np.random.RandomState(cfg["input_seed"])
    shape = (cfg["B"], cfg["K"], cfg["H"], cfg["W"], cfg["C"])
    p = rng.uniform(-1, 1, shape).astype(np.float32)
    f = rng.uniform(-1, 1, (cfg["B"], cfg["F"]) + shape[2:]).astype(np.float32)
    return p, f


def golden_points(cfg=COLOR_GOLDEN) -> np.ndarray:
    """Flat indices into a [B, T, H, W, C] output where the color golden keeps float values."""
    n = cfg["B"] * cfg["T"] * cfg["H"] * cfg["W"] * cfg["C"]
    return np.random.RandomState(cfg["point_seed"]).choice(n, cfg["n_points"], replace=False).astype(np.int32)


def model_spec(key: str, impl=None) -> dict:
    """A registry key's spec, with ``sepconv_impl`` set where ``impl`` is given."""
    spec = copy.deepcopy(model_config(key))
    if impl is not None:
        spec["kwargs"]["sepconv_impl"] = impl
    return spec


def _random_like(tree, rng: np.random.RandomState):
    """Standard normals shaped like a nested dict of arrays, drawn in sorted key order."""
    return {k: _random_like(v, rng) if isinstance(v, dict) else rng.standard_normal(np.shape(v)).astype(np.float32)
            for k, v in sorted(tree.items())}


def train_golden_setup(cfg=TRAIN_GOLDEN):
    """The training golden's inputs: (TrainConfig, flax G params, flax D
    variables, targets [B, K+T+F, H, W, C], r_g, r_d).  r_g and r_d are
    port-layout state dicts of projection vectors, one per parameter, drawn
    in sorted flax-path order (G, then D) from ``RandomState(proj_seed)``."""
    train_cfg = TrainConfig(K=cfg["K"], T=cfg["T"], F=cfg["F"])
    g_params = random_jax_params(cfg["model_key"], cfg["param_seed"])
    d_vars = random_jax_disc_variables(train_cfg, cfg["H"], cfg["W"], cfg["C"], cfg["disc_seed"])
    shape = (cfg["B"], cfg["K"] + cfg["T"] + cfg["F"], cfg["H"], cfg["W"], cfg["C"])
    targets = np.random.RandomState(cfg["input_seed"]).uniform(-1, 1, shape).astype(np.float32)
    rng = np.random.RandomState(cfg["proj_seed"])
    r_g = params_from_jax(_random_like(g_params, rng))
    r_d = disc_variables_from_jax({"params": _random_like(d_vars["params"], rng)})
    return train_cfg, g_params, d_vars, targets, r_g, r_d


def grad_projections(grads, r) -> np.ndarray:
    """<grad[k], r[k]> for every key of r, in its order, summed in float64."""
    return np.array([float((grads[k].double() * r[k].to(grads[k].device).double()).sum()) for k in r])


def _global_rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def check_train_golden(device: torch.device, cfg=TRAIN_GOLDEN):
    """The port's f32 training steps on ``device`` against the JAX training
    golden.  Returns (report, env, state, targets on the device)."""
    golden = np.load(TRAIN_GOLDEN_PATH)
    meta_ok = all(str(golden[k]) == str(v) for k, v in cfg.items())
    train_cfg, g_params, d_vars, targets, r_g, r_d = train_golden_setup(cfg)
    K, T, F = cfg["K"], cfg["T"], cfg["F"]
    env = create_training_environment(create_model(cfg["model_key"]), train_cfg)
    state = env.init_state((cfg["H"], cfg["W"]), g_params=g_params, d_variables=d_vars, device=device)
    terms = []
    for step in range(cfg["steps"]):
        state, m = env.train_step(state, K, T, F, targets)
        terms.append([float(m[n]) for n in golden["term_names"]])
        if step == 0:
            g_proj = grad_projections({n: p.grad for n, p in state.generator.named_parameters()}, r_g)
            d_proj = grad_projections({n: p.grad for n, p in state.discriminator.named_parameters()}, r_d)
    terms_rel = np.abs(np.array(terms) - golden["terms"]) / np.maximum(np.abs(golden["terms"]), 1e-12)
    report = dict(meta_ok=meta_ok, terms_max_rel=float(terms_rel.max()),
                  worst_term=str(golden["term_names"][terms_rel.max(axis=0).argmax()]),
                  g_proj_rel=_global_rel(g_proj, golden["g_proj"]), d_proj_rel=_global_rel(d_proj, golden["d_proj"]))
    report["ok"] = bool(meta_ok and report["terms_max_rel"] <= 1e-3 and report["g_proj_rel"] <= 1e-3
                        and report["d_proj_rel"] <= 1e-3)
    return report, env, state, torch.as_tensor(targets, device=device)


def check_color_golden(out: dict, golden) -> dict:
    """A TAI_color forward's outputs on the color golden's inputs against the
    golden: each output's max-abs at the golden's points, and the uint8 PSNR
    of pred's frames."""
    idx = golden["points"]
    res = {}
    for key in PRED_KEYS:
        got = out[key].float().cpu().numpy()
        res[f"{key}_max_abs"] = float(np.abs(got.reshape(-1)[idx] - golden[f"{key}_at_points"]).max())
        if key == "pred":
            res["pred_u8_psnr_db"] = u8_psnr(u8(got), golden["pred_u8"])
    return res


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def gate(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: gate failed: {what}")


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    raise SystemExit(f"chip_smoke: no data-sheet peaks for {name!r}; add them to PEAKS")


def u8(x: np.ndarray) -> np.ndarray:
    return np.round(np.clip((x + 1.0) / 2.0, 0.0, 1.0) * 255.0).astype(np.uint8)


def u8_psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10.0 * math.log10(255.0**2 / max(mse, 1e-10))  # 148 dB when identical


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sepconv_operands(BT, H, W, C, ks, dtype, gen):
    """O(1) outputs: x in [0, 1.5], v and h in [0, 2/ks]; v and h laid out as
    the kernel heads give them (NCHW permuted to [B, H, W, ks])."""
    x = torch.rand(BT, H + ks - 1, W + ks - 1, C, device="cuda", generator=gen) * 1.5
    v = (torch.rand(BT, ks, H, W, device="cuda", generator=gen) * (2.0 / ks)).permute(0, 2, 3, 1)
    h = (torch.rand(BT, ks, H, W, device="cuda", generator=gen) * (2.0 / ks)).permute(0, 2, 3, 1)
    return x.to(dtype), v.to(dtype), h.to(dtype)


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |t| (8 significant bits)."""
    e = torch.floor(torch.log2(t.abs().clamp_min(2.0**-126)))
    return torch.exp2(e - 7)


def _bound(nbytes: int, ops: int, dtype, peak):
    bw, flops_bf16, flops_f32 = peak
    t_bytes = nbytes / bw * 1e3
    t_ops = ops / (flops_bf16 if dtype == torch.bfloat16 else flops_f32) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sepconv_bound_ms(x, v, h, peak):
    """Reads x, v, h and writes out once; 2*ks*(ks+1) flops per output pixel
    and channel (the separable form: ks+1 multiply-adds per tap row).  The
    same bound for both forward kernels: they compute the same function."""
    B, H, W, ks = v.shape
    C = x.shape[-1]
    nbytes = (x.numel() + v.numel() + h.numel() + B * H * W * C) * x.element_size()
    return _bound(nbytes, 2 * ks * (ks + 1) * B * H * W * C, x.dtype, peak)


def sepconv_bwd_vh_bound_ms(x, v, h, g, peak):
    """Reads x, v, h, g and writes grad_v, grad_h once.  Per output pixel and
    channel, 4*ks*(ks+1) flops: the horizontal pass sum_j x*h and the vertical
    pass sum_f v*x (ks^2 multiply-adds each) and the products of their ks
    sums with g (2*ks multiply-adds)."""
    B, H, W, ks = v.shape
    C = x.shape[-1]
    nbytes = (x.numel() + 2 * v.numel() + 2 * h.numel() + g.numel()) * x.element_size()
    return _bound(nbytes, 4 * ks * (ks + 1) * B * H * W * C, x.dtype, peak)


def sepconv_bwd_x_bound_ms(v, h, g, peak):
    """Reads v, h, g and writes grad_x once.  Per output pixel and channel,
    ks*(2*ks+1) flops: g*v[f] (ks multiplies), then (g*v[f])*h[j] added into
    grad_x for every (f, j) (ks^2 multiply-adds)."""
    B, H, W, ks = v.shape
    C = g.shape[-1]
    nbytes = (v.numel() + h.numel() + g.numel() + B * (H + ks - 1) * (W + ks - 1) * C) * g.element_size()
    return _bound(nbytes, ks * (2 * ks + 1) * B * H * W * C, g.dtype, peak)


def _adjoint_cases(BT, H, W, C, ks, dtype, gen, expand_g=False):
    """Operands of the two adjoints: x, v, h as for the forward; g in [-1, 1]
    for f32, in [0, 1] for bf16 (no cancellation, so a bf16 ulp of every
    output is meaningful); with ``expand_g`` one value per image expanded to
    [B, H, W, C] with stride 0, as a sum's cotangent arrives."""
    x, v, h = sepconv_operands(BT, H, W, C, ks, dtype, gen)
    lo = -1.0 if dtype == torch.float32 else 0.0
    if expand_g:
        g = (torch.rand(BT, 1, 1, 1, device="cuda", generator=gen) * (1 - lo) + lo).expand(BT, H, W, C)
    else:
        g = torch.rand(BT, H, W, C, device="cuda", generator=gen) * (1 - lo) + lo
    return x, v, h, g.to(dtype)


def _bf16_gate(got, want) -> tuple[float, float]:
    diff = (got.float() - want).abs()
    return float(diff.max()), float((diff / bf16_ulp(want)).max())


def phase_adjoint_checks(gen) -> dict:
    """Both adjoint kernels against the plain adjoints on the card; returns
    each kernel's f32 max error at the main-path shape."""
    main_err = {}
    cases = [  # (B*T, H, W, C, ks, expand_g)
        (40, 128, 128, 1, KS, False),  # TAI_gray training, B=8: 2 calls per G step
        (4, 256, 320, 3, KS, False),  # TAI_color at 256x320
        (3, 37, 45, 3, 4, True),  # ragged, even ks, stride-0 cotangent
    ]
    for BT, H, W, C, ks, expand_g in cases:
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            x, v, h, g = _adjoint_cases(BT, H, W, C, ks, dtype, gen, expand_g)
            wide = [t.float() for t in (x, v, h, g)]
            got_v, got_h = sepconv_ops.sepconv_bwd_vh_cuda(x, v, h, g)
            got_x = sepconv_ops.sepconv_bwd_x_cuda(v, h, g)
            torch.cuda.synchronize()
            gate(got_v.stride() == v.stride() and got_h.stride() == h.stride(),
                 f"adjoint gradients not laid out like v, h: {got_v.stride()} vs {v.stride()}")
            want_v, want_h = sepconv_ops.sepconv_bwd_vh_plain(*wide)
            want_x = sepconv_ops.sepconv_bwd_x_plain(*wide[1:])
            for name, got, want in (("grad_v", got_v, want_v), ("grad_h", got_h, want_h), ("grad_x", got_x, want_x)):
                kernel = "sepconv_bwd_x" if name == "grad_x" else "sepconv_bwd_vh"
                ref_max = float(want.abs().max())
                if dtype == torch.float32:
                    err = float((got - want).abs().max())
                    errs[(kernel, name, "f32_max_abs")] = err
                    gate(err <= 1e-4 * max(1.0, ref_max),
                         f"{kernel} {name} f32 {BT, H, W, C, ks}: max_abs {err} > 1e-4 * max(1, {ref_max})")
                else:
                    err, ulps = _bf16_gate(got, want)
                    errs[(kernel, name, "bf16_max_abs")] = err
                    errs[(kernel, name, "bf16_max_ulps")] = ulps
                    gate(ulps <= 1.0, f"{kernel} {name} bf16 {BT, H, W, C, ks}: {ulps} bf16 ulps off")
                errs[(kernel, name, "ref_max_abs")] = ref_max
            del x, v, h, g, wide, got_v, got_h, got_x, want_v, want_h, want_x
            torch.cuda.empty_cache()
        for kernel in ("sepconv_bwd_vh", "sepconv_bwd_x"):
            emit("kernel", kernel=kernel, shape=[BT, H, W, C, ks], g_stride0=expand_g,
                 **{f"{n}_{m}": e for (k, n, m), e in errs.items() if k == kernel})
            if (BT, H, W, C) == (40, 128, 128, 1):
                main_err[kernel] = max(e for (k, n, m), e in errs.items() if k == kernel and m == "f32_max_abs")
    return main_err


# Images of a batch that the tiling emulation is compared on (it holds the
# whole slab and S in float32).
EMULATED_IMAGES = 8


def phase_kernel_checks(gen) -> dict:
    """Both forward kernels against their plain versions on the card, the
    banded one also against the emulation of its tiling; returns each
    kernel's f32 max error at the main-path shape."""
    main_err = {}
    cases = [  # (B*T, H, W, C, ks)
        (40, 128, 128, 1, KS),  # TAI_gray serving, B=8
        (320, 128, 128, 1, KS),  # TAI_gray serving, B=64
        (80, 256, 320, 3, KS),  # TAI_color at 256x320, serving B=16
        (3, 37, 45, 3, 4),  # ragged, even ks
    ]
    for BT, H, W, C, ks in cases:
        x, v, h = sepconv_operands(BT, H, W, C, ks, torch.float32, gen)
        xb, vb, hb = (t.to(torch.bfloat16) for t in (x, v, h))
        for name, (kernel, plain, _) in FORWARDS.items():
            want = plain(x, v, h)
            got = kernel(x, v, h)
            torch.cuda.synchronize()
            ref_max = float(want.abs().max())
            err32 = float((got - want).abs().max())
            want_b = plain(xb.float(), vb.float(), hb.float())
            got_b = kernel(xb, vb, hb)
            torch.cuda.synchronize()
            err16, ulps16 = _bf16_gate(got_b, want_b)
            extra = {}
            if name == "sepconv_fwd_mxu":
                n = min(BT, EMULATED_IMAGES)
                emul = sepconv_ops._sepconv_mxu_tiled(x[:n], v[:n], h[:n])
                emul_b = sepconv_ops._sepconv_mxu_tiled(xb[:n], vb[:n], hb[:n])
                extra = dict(emulated_images=n, f32_vs_emulation_max_abs=float((got[:n] - emul).abs().max()),
                             bf16_vs_emulation_max_abs=float((got_b[:n].float() - emul_b.float()).abs().max()))
                del emul, emul_b
            emit("kernel", kernel=name, plain=plain.__name__, shape=[BT, H, W, C, ks], f32_max_abs=err32,
                 bf16_max_abs=err16, bf16_max_ulps=ulps16, ref_max_abs=ref_max, **extra)
            gate(err32 <= 1e-4 * max(1.0, ref_max),
                 f"{name} f32 {BT, H, W, C, ks}: max_abs {err32} > 1e-4 * max(1, {ref_max})")
            gate(ulps16 <= 1.0, f"{name} bf16 {BT, H, W, C, ks}: {ulps16} bf16 ulps off")
            if (BT, H, W, C) == (320, 128, 128, 1):
                main_err[name] = err32
            del want, got, want_b, got_b
            torch.cuda.empty_cache()
        del x, v, h, xb, vb, hb
        torch.cuda.empty_cache()
    return main_err


def _launch_counts() -> dict:
    return {k: getattr(sepconv_ops, f"{k}_launches") for k in KERNELS}


def _reset_launch_counts() -> None:
    for k in KERNELS:
        setattr(sepconv_ops, f"{k}_launches", 0)


def _gate_launches(path: str, launches: dict, want: dict) -> None:
    for k in KERNELS:
        gate(launches[k] == want.get(k, 0), f"{path}: {k} launched {launches[k]} times, want {want.get(k, 0)}")


@contextlib.contextmanager
def uncounted():
    """Launches inside (timings of a kernel alone) leave the counts as they were."""
    saved = _launch_counts()
    try:
        yield
    finally:
        for k, n in saved.items():
            setattr(sepconv_ops, f"{k}_launches", n)


def phase_serve(state, impl=None) -> dict:
    """TAI_gray serving through the route ``impl`` picks: golden check in f32,
    then uint8 requests in f32 and bf16.  Returns the launches of this path."""
    cfg = GOLDEN
    phase = "serve" if impl is None else f"serve_{impl}"
    golden = np.load(GOLDEN_PATH)
    for k, val in cfg.items():
        gate(str(golden[k]) == str(val), f"golden fixture {k}={golden[k]} but chip_smoke uses {val}")
    spec = model_spec(cfg["model_key"], impl)
    ip32 = VideoInpainter(spec, state, device="cuda", dtype=torch.float32)
    ip16 = VideoInpainter(spec, state, device="cuda", dtype=torch.bfloat16)
    p, f = golden_inputs()
    _reset_launch_counts()
    with torch.inference_mode():
        out = ip32.model(cfg["T"], torch.from_numpy(p).cuda(), torch.from_numpy(f).cuda())
    n_forwards = 1
    res = {}
    for key in PRED_KEYS:
        got = out[key].float().cpu().numpy()
        res[key] = (float(np.abs(got - golden[key]).max()), u8_psnr(u8(got), u8(golden[key])))
    emit(f"{phase}_golden", dtype="float32", tf32=False, sepconv_impl=impl,
         **{f"{k}_max_abs": v[0] for k, v in res.items()}, **{f"{k}_u8_psnr_db": v[1] for k, v in res.items()})
    for key, (err, psnr) in res.items():
        gate(err <= 5e-3, f"{phase}: {key} max_abs {err} > 5e-3 against the JAX golden")
        gate(psnr >= 45.0, f"{phase}: {key} uint8 PSNR {psnr} dB < 45 against the JAX golden")

    rng = np.random.RandomState(2)
    B, K, T, H, W = 8, cfg["K"], cfg["T"], cfg["H"], cfg["W"]
    requests = [(rng.randint(0, 256, (B, K, H, W, 3), np.uint8), rng.randint(0, 256, (B, K, H, W, 3), np.uint8))
                for _ in range(2)]
    outs = {}
    for name, ip in (("float32", ip32), ("bfloat16", ip16)):
        outs[name] = []
        for pre, fol in requests:
            o = ip.inpaint(pre, fol, T)
            n_forwards += 1
            gate(o.shape == (B, T, H, W, 1) and o.dtype == np.uint8, f"inpaint gave {o.shape} {o.dtype}")
            outs[name].append(o)
    launches = _launch_counts()
    emit(f"{phase}_requests", batch=B, requests_per_dtype=len(requests), forwards=n_forwards, **launches)
    _gate_launches(phase, launches, {ROUTE_FORWARD[impl]: 2 * n_forwards})

    # bf16 against f32 on the same requests (recorded, not gated).
    with uncounted():
        pre, fol = (ip32._to_model(r, True) for r in requests[0])
        diff = ip32.forward(T, pre, fol) - ip16.forward(T, pre.bfloat16(), fol.bfloat16()).float()
    psnr = min(u8_psnr(x16, x32) for x16, x32 in zip(outs["bfloat16"], outs["float32"]))
    emit(f"{phase}_bf16_vs_f32", max_abs=float(diff.abs().max()), u8_psnr_db=psnr)
    return launches


def phase_serve_color() -> dict:
    """TAI_color at 256x320, default route: f32 against the color golden, then
    bf16 uint8 requests at B=16.  Returns the launches of this path."""
    cfg = COLOR_GOLDEN
    golden = np.load(COLOR_GOLDEN_PATH)
    for k, val in cfg.items():
        gate(str(golden[k]) == str(val), f"color golden fixture {k}={golden[k]} but chip_smoke uses {val}")
    gate(np.array_equal(golden["points"], golden_points()), "color golden points differ from golden_points()")
    state = params_from_jax(random_jax_params(cfg["model_key"], cfg["param_seed"]))
    ip32 = VideoInpainter(cfg["model_key"], state, device="cuda", dtype=torch.float32)
    ip16 = VideoInpainter(cfg["model_key"], state, device="cuda", dtype=torch.bfloat16)
    p, f = golden_inputs(cfg)
    _reset_launch_counts()
    with torch.inference_mode():
        out = ip32.model(cfg["T"], torch.from_numpy(p).cuda(), torch.from_numpy(f).cuda())
    n_forwards = 1
    res = check_color_golden(out, golden)
    emit("serve_color_golden", dtype="float32", tf32=False, shape=[cfg["H"], cfg["W"], cfg["C"]], **res)
    for key in PRED_KEYS:
        gate(res[f"{key}_max_abs"] <= 5e-3, f"serve_color: {key} max_abs {res[f'{key}_max_abs']} > 5e-3")
    gate(res["pred_u8_psnr_db"] >= 45.0, f"serve_color: pred uint8 PSNR {res['pred_u8_psnr_db']} dB < 45")

    rng = np.random.RandomState(3)
    B, K, T, H, W = 16, 5, 5, cfg["H"], cfg["W"]
    requests = [(rng.randint(0, 256, (B, K, H, W, 3), np.uint8), rng.randint(0, 256, (B, K, H, W, 3), np.uint8))
                for _ in range(2)]
    outs = []
    for pre, fol in requests:
        o = ip16.inpaint(pre, fol, T)
        n_forwards += 1
        gate(o.shape == (B, T, H, W, 3) and o.dtype == np.uint8, f"color inpaint gave {o.shape} {o.dtype}")
        outs.append(o)
    launches = _launch_counts()
    emit("serve_color_requests", dtype="bfloat16", batch=B, T=T, requests=len(requests), forwards=n_forwards,
         **launches)
    _gate_launches("serve_color", launches, {"sepconv_fwd_mxu": 2 * n_forwards})
    with uncounted():
        o32 = ip32.inpaint(*requests[0], T)
    emit("serve_color_bf16_vs_f32", u8_psnr_db=u8_psnr(outs[0], o32))
    return launches


def phase_train_golden():
    """Two f32 training steps at B=2 against the JAX golden (TF32 off)."""
    report, env, state, targets = check_train_golden(torch.device("cuda"))
    emit("train_golden", dtype="float32", tf32=False, batch=TRAIN_GOLDEN["B"], **report)
    gate(report["meta_ok"], "training golden fixture does not match TRAIN_GOLDEN")
    gate(report["terms_max_rel"] <= 1e-3, f"loss term {report['worst_term']} off the golden by rel "
                                          f"{report['terms_max_rel']} > 1e-3")
    gate(report["g_proj_rel"] <= 1e-3, f"G gradient projections off the golden by {report['g_proj_rel']} > 1e-3")
    gate(report["d_proj_rel"] <= 1e-3, f"D gradient projections off the golden by {report['d_proj_rel']} > 1e-3")
    return env, state, targets


def phase_train_kernel_vs_plain(env, state, targets) -> None:
    """The G gradient on the path through the adjoint kernels against the same
    gradient with the plain adjoints put in their place (for this check only)."""
    K, T, F = TRAIN_GOLDEN["K"], TRAIN_GOLDEN["T"], TRAIN_GOLDEN["F"]
    params = list(state.generator.parameters())
    grads = {}
    kernels = (sepconv_ops.sepconv_bwd_vh_cuda, sepconv_ops.sepconv_bwd_x_cuda)
    for route in ("kernels", "plain"):
        before = _launch_counts()
        if route == "plain":
            sepconv_ops.sepconv_bwd_vh_cuda = sepconv_ops.sepconv_bwd_vh_plain
            sepconv_ops.sepconv_bwd_x_cuda = sepconv_ops.sepconv_bwd_x_plain
        try:
            loss, _ = env._g_loss(state, K, T, F, targets)
            grads[route] = torch.autograd.grad(loss, params, allow_unused=True)
        finally:
            sepconv_ops.sepconv_bwd_vh_cuda, sepconv_ops.sepconv_bwd_x_cuda = kernels
        after = _launch_counts()
        adjoint_launches = sum(after[k] - before[k] for k in ("sepconv_bwd_vh", "sepconv_bwd_x"))
        gate(adjoint_launches == (4 if route == "kernels" else 0),
             f"{route} route launched the adjoint kernels {adjoint_launches} times")
    err = _grads_rel(grads["kernels"], grads["plain"])
    emit("train_kernel_vs_plain", dtype="float32", batch=TRAIN_GOLDEN["B"], g_grad_global_rel=err)
    gate(err <= 1e-4, f"G gradient through the kernels off the plain adjoints by {err} > 1e-4")


def _grads_rel(got, want) -> float:
    """Global-L2-relative difference of two gradient lists (None where unused)."""
    num = sum(float(((a - b).double() ** 2).sum()) for a, b in zip(got, want) if a is not None)
    den = sum(float((b.double() ** 2).sum()) for b in want if b is not None)
    return (num / den) ** 0.5


def phase_train_pallas() -> dict:
    """One f32 G update of TAI_gray at B=2 (the training golden's weights and
    batch) through each forward kernel; the G gradients against each other.
    Returns the launches of the ``"pallas"`` route's update."""
    cfg = TRAIN_GOLDEN
    train_cfg, g_params, d_vars, targets, _, _ = train_golden_setup(cfg)
    K, T, F = cfg["K"], cfg["T"], cfg["F"]
    grads, launches = {}, {}
    for impl in (None, "pallas"):
        env = create_training_environment(create_model(model_spec(cfg["model_key"], impl)), train_cfg)
        state = env.init_state((cfg["H"], cfg["W"]), g_params=g_params, d_variables=d_vars, device="cuda")
        _reset_launch_counts()
        env._g_update(state, K, T, F, torch.as_tensor(targets, device="cuda"))
        torch.cuda.synchronize()
        launches[impl] = _launch_counts()
        _gate_launches(f"train_pallas[{impl}]", launches[impl],
                       {ROUTE_FORWARD[impl]: 2, "sepconv_bwd_vh": 2, "sepconv_bwd_x": 2})
        grads[impl] = [p.grad.clone() for p in state.generator.parameters()]
        del env, state
    err = _grads_rel(grads["pallas"], grads[None])
    emit("train_pallas", dtype="float32", tf32=False, batch=cfg["B"], g_grad_global_rel_pallas_vs_pallas_mxu=err,
         launches_pallas=launches["pallas"], launches_pallas_mxu=launches[None])
    gate(err <= 1e-3, f"G gradients through the two forward kernels differ by {err} > 1e-3")
    return launches["pallas"]


def _train_run(key: str, B: int, H: int, W: int, C: int, dtype: str, gen, warmup: int, timed: int, split: int):
    """Train ``key`` at [B, 15, H, W, C] on the default route: ``warmup``
    steps, ``timed`` steps timed together, ``split`` steps with the G and D
    updates timed apart.  Emits the ``train`` line; returns the G updates run."""
    K = T = F = 5
    cfg = TrainConfig(K=K, T=T, F=F, train_dtype=dtype)
    env = create_training_environment(create_model(key), cfg)
    targets = torch.rand(B, K + T + F, H, W, C, device="cuda", generator=gen) * 2 - 1
    state = env.init_state((H, W), g_params=random_jax_params(key, 0), device="cuda", seed=1)
    terms = []
    for _ in range(warmup):
        state, m = env.train_step(state, K, T, F, targets)
        terms.append(m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = None
    if timed:
        t0 = time.perf_counter()
        for _ in range(timed):
            state, m = env.train_step(state, K, T, F, targets)
            terms.append(m)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / timed * 1e3
    g_ms, d_ms = [], []
    for _ in range(split):
        t0 = time.perf_counter()
        pred, m = env._g_update(state, K, T, F, targets)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m.update(env._d_update(state, pred, K, T, F, targets))
        torch.cuda.synchronize()
        g_ms.append((t1 - t0) * 1e3)
        d_ms.append((time.perf_counter() - t1) * 1e3)
        terms.append(m)
    last = {k: float(v) for k, v in terms[-1].items()}
    finite = all(math.isfinite(float(v)) for m in terms for v in m.values())
    emit("train", model=key, dtype=dtype, batch=B, K=K, T=T, F=F, shape=[H, W, C], tf32=False,
         ms_per_step=step_ms, g_update_ms=sorted(g_ms)[len(g_ms) // 2], d_update_ms=sorted(d_ms)[len(d_ms) // 2],
         g_update_ms_all=g_ms, d_update_ms_all=d_ms, max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         steps=state.step, last_terms=last)
    gate(finite, f"non-finite loss terms in {key} {dtype} training")
    del env, state, targets, terms
    torch.cuda.empty_cache()
    return warmup + timed + split


def _expect_train(n_g_updates: int) -> dict:
    return {"sepconv_fwd_mxu": 2 * n_g_updates, "sepconv_bwd_vh": 2 * n_g_updates, "sepconv_bwd_x": 2 * n_g_updates}


def phase_train(gen) -> dict:
    """TAI_gray training at full width, B=8, bf16 mixed precision then f32:
    3 warm-up steps, 5 timed steps, 3 steps with the G and D updates timed
    apart.  Returns each kernel's launches in this path's run."""
    _reset_launch_counts()
    n_g_updates = sum(_train_run("TAI_gray", 8, 128, 128, 1, dtype, gen, 3, 5, 3) for dtype in ("bfloat16", "float32"))
    launches = _launch_counts()
    emit("train_launches", model="TAI_gray", g_updates=n_g_updates, **launches)
    _gate_launches("train", launches, _expect_train(n_g_updates))
    return launches


def phase_train_color(gen) -> dict:
    """TAI_color at 256x320, B=4, bf16 mixed precision: 1 warm-up step, then
    3 steps with the G and D updates timed apart."""
    _reset_launch_counts()
    n_g_updates = _train_run("TAI_color", 4, 256, 320, 3, "bfloat16", gen, 1, 0, 3)
    launches = _launch_counts()
    emit("train_color_launches", model="TAI_color", g_updates=n_g_updates, **launches)
    _gate_launches("train_color", launches, _expect_train(n_g_updates))
    return launches


def phase_timing(state, peak, main_err: dict, adj_err: dict, path_launches: dict, gen):
    # TAI_gray serving at B=64 and training at B=8, TAI_color serving at B=16
    shapes = {"gray": (320, 128, 128, 1), "gray_train": (40, 128, 128, 1), "color": (80, 256, 320, 3)}
    fwd = {}
    for shape_name, (BT, H, W, C) in shapes.items():
        for dtype in (torch.bfloat16, torch.float32):
            x, v, h = sepconv_operands(BT, H, W, C, KS, dtype, gen)
            bound, by = sepconv_bound_ms(x, v, h, peak)
            for name, (kernel, plain, _) in FORWARDS.items():
                with uncounted():
                    ms = cuda_ms(lambda: kernel(x, v, h), iters=10)
                plain_ms = cuda_ms(lambda: plain(x, v, h), iters=2, warmup=1)
                fwd[name, shape_name, dtype] = (ms, plain_ms, bound, by)
                emit("timing_kernel", kernel=name, dtype=str(dtype), shape=[BT, H, W, C, KS], ms=ms,
                     plain=plain.__name__, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                     achieved_over_bound=bound / ms)
                torch.cuda.empty_cache()
            del x, v, h
            torch.cuda.empty_cache()

    T = GOLDEN["T"]
    H = W = 128
    serve_runs = [("TAI_gray", None, torch.bfloat16, 8), ("TAI_gray", None, torch.bfloat16, 64),
                  ("TAI_gray", "pallas", torch.bfloat16, 64), ("TAI_gray", None, torch.float32, 8),
                  ("TAI_gray", None, torch.float32, 64)]
    for key, impl, dtype, B in serve_runs:
        ip = VideoInpainter(model_spec(key, impl), state, device="cuda", dtype=dtype)
        _serve_timing(ip, key, impl, dtype, B, T, H, W, 1, gen)
        del ip
        torch.cuda.empty_cache()
    color = params_from_jax(random_jax_params("TAI_color", 0))
    ip = VideoInpainter("TAI_color", color, device="cuda", dtype=torch.bfloat16)
    _serve_timing(ip, "TAI_color", None, torch.bfloat16, 16, T, 256, 320, 3, gen)
    del ip
    torch.cuda.empty_cache()

    adj = {}
    C = 1
    for dtype in (torch.bfloat16, torch.float32):
        x, v, h, g = _adjoint_cases(40, H, W, C, KS, dtype, gen)
        runs = {
            "sepconv_bwd_vh": (lambda: sepconv_ops.sepconv_bwd_vh_cuda(x, v, h, g),
                               lambda: sepconv_ops.sepconv_bwd_vh_plain(x, v, h, g),
                               sepconv_bwd_vh_bound_ms(x, v, h, g, peak)),
            "sepconv_bwd_x": (lambda: sepconv_ops.sepconv_bwd_x_cuda(v, h, g),
                              lambda: sepconv_ops.sepconv_bwd_x_plain(v, h, g),
                              sepconv_bwd_x_bound_ms(v, h, g, peak)),
        }
        for name, (kernel, plain, (bound, by)) in runs.items():
            with uncounted():
                ms = cuda_ms(kernel, iters=10)
            plain_ms = cuda_ms(plain, iters=3, warmup=1)
            adj[name, dtype] = (ms, plain_ms, bound, by)
            emit("timing_kernel", kernel=name, dtype=str(dtype), shape=[40, H, W, C, KS], ms=ms,
                 plain_ms=plain_ms, bound_ms=bound, bound_by=by, achieved_over_bound=bound / ms)
        del x, v, h, g, runs
        torch.cuda.empty_cache()

    def launches(name):
        by_path = {p: n[name] for p, n in path_launches.items() if n[name]}
        return sum(by_path.values()), by_path

    kernels = []
    for name, (_, plain, line) in FORWARDS.items():
        ms16, plain16, bound16, by16 = fwd[name, "gray", torch.bfloat16]
        ms32, plain32, bound32, by32 = fwd[name, "gray", torch.float32]
        c16, cplain16, cbound16, _ = fwd[name, "color", torch.bfloat16]
        c32, cplain32, cbound32, _ = fwd[name, "color", torch.float32]
        t16, _, tbound16, _ = fwd[name, "gray_train", torch.bfloat16]
        total, by_path = launches(name)
        kernels.append({
            "name": name, "route": "cuda", "source": f"vfi_tpu_torch/ops/csrc/{name}.cu",
            "replaces": f"vfi_tpu/ops/sepconv.py:{line}", "launches": total, "launches_by_path": by_path,
            "max_abs_err": main_err[name], "ms": ms16, "plain_ms": plain16, "bound_ms": bound16, "bound_by": by16,
            "library_ms": None, "shape": [320, H, W, 1, KS], "dtype": "bfloat16", "plain": plain.__name__,
            "ms_f32": ms32, "plain_ms_f32": plain32, "bound_ms_f32": bound32, "bound_by_f32": by32,
            "color_shape": [80, 256, 320, 3, KS], "color_ms": c16, "color_plain_ms": cplain16,
            "color_bound_ms": cbound16, "color_ms_f32": c32, "color_plain_ms_f32": cplain32,
            "color_bound_ms_f32": cbound32, "train_shape": [40, H, W, 1, KS], "train_ms": t16,
            "train_bound_ms": tbound16,
        })
    for name, line in (("sepconv_bwd_vh", 608), ("sepconv_bwd_x", 729)):
        ms16, plain16, bound16, by16 = adj[name, torch.bfloat16]
        ms32, plain32, bound32, by32 = adj[name, torch.float32]
        total, by_path = launches(name)
        kernels.append({
            "name": name, "route": "cuda", "source": f"vfi_tpu_torch/ops/csrc/{name}.cu",
            "replaces": f"vfi_tpu/ops/sepconv.py:{line}", "launches": total, "launches_by_path": by_path,
            "max_abs_err": adj_err[name], "ms": ms16, "plain_ms": plain16, "bound_ms": bound16, "bound_by": by16,
            "library_ms": None, "shape": [40, H, W, C, KS], "dtype": "bfloat16",
            "ms_f32": ms32, "plain_ms_f32": plain32, "bound_ms_f32": bound32, "bound_by_f32": by32,
        })
    print(json.dumps({"kernels": kernels}), flush=True)


def _serve_timing(ip, key, impl, dtype, B, T, H, W, C, gen) -> None:
    p = torch.rand(B, 5, H, W, C, device="cuda", generator=gen).to(dtype) * 2 - 1
    f = torch.rand(B, 5, H, W, C, device="cuda", generator=gen).to(dtype) * 2 - 1
    torch.cuda.reset_peak_memory_stats()
    with uncounted():
        ms = cuda_ms(lambda: ip.forward(T, p, f), iters=5)
    emit("timing_serve", model=key, sepconv_impl=impl, dtype=str(dtype), batch=B, T=T, shape=[H, W, C], tf32=False,
         ms_per_batch=ms, middle_frames_per_s=B * T / (ms / 1e3),
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs a GPU", file=sys.stderr)
        return 2
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    peak_name, peak = peaks(name)
    emit("device", name=name, count=torch.cuda.device_count(), nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, peaks_from=f"{peak_name} data sheet")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    seconds = _kernels.build_all()
    ptxas = {n: [ln.strip() for ln in _kernels.build_log(n).splitlines() if "registers" in ln or "spill" in ln]
             for n in _kernels.SOURCES}
    emit("build", seconds=seconds, wall_s=time.perf_counter() - t0, ptxas=ptxas)
    gate(len(_kernels.SOURCES) == len(KERNELS), f"built {sorted(_kernels.SOURCES)}, the path runs {KERNELS}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    main_err = phase_kernel_checks(gen)
    adj_err = phase_adjoint_checks(gen)
    state = params_from_jax(random_jax_params(GOLDEN["model_key"], GOLDEN["param_seed"]))
    paths = {"serve": phase_serve(state), "serve_pallas": phase_serve(state, "pallas"),
             "serve_color": phase_serve_color()}
    env, tstate, targets = phase_train_golden()
    phase_train_kernel_vs_plain(env, tstate, targets)
    del env, tstate, targets
    torch.cuda.empty_cache()
    paths["train_pallas"] = phase_train_pallas()
    torch.cuda.empty_cache()
    paths["train"] = phase_train(gen)
    paths["train_color"] = phase_train_color(gen)
    phase_timing(state, peak, main_err, adj_err, paths, gen)

    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

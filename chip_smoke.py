#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--baseline CHECKOUT]

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
                   (four sources), all nvcc processes at once; fails if ptxas
                   reports a spill in any instantiation.
  3. kernel      — each kernel against its plain PyTorch version on the card:
                   f32 (TF32 off) within 1e-4 * max(1, max|ref|); bf16 within
                   one bf16 ulp of the f32 plain version on the same bf16
                   inputs.  The banded kernel also against the emulation of
                   its tiling (``_sepconv_mxu_tiled``), recorded; the two
                   adjoints also at the TAI_color training shape and, on 2
                   images of each training shape, against the emulations of
                   their tiling (f32 within 1e-5 * max(1, max|emulation|),
                   bf16 within one bf16 ulp).
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
  7. predict     — TAI_gray served by ``vfi_tpu_torch.cli.predict`` from a
                   port snapshot (``utils/checkpoint.py``) of the seed-0
                   weights, on 130 synthetic clips of exactly 15 frames:
                   bf16 ``--device_normalize`` at B=64 (batches 64, 64 and 2
                   padded to 64) writes 130 folders of 20 PNGs with 6
                   banded and 0 direct launches and one padding line; f32
                   (TF32 off) on the first 16 clips at B=8, each pred_middle
                   PNG within 1 uint8 level of
                   ``VideoInpainter.from_checkpoint(...).inpaint``;
                   ``cli.compute_quant_results`` on that output, with its
                   metrics on the card, against float64 numpy: |dPSNR| <=
                   1e-3 dB, |dSSIM| <= 1e-4; one batch of 8 clips under a
                   JSON model key with ``"sepconv_impl": "pallas"``: 2 direct
                   and 0 banded launches.  Then ``timing_predict``: the bf16
                   run timed at VFI_INFLIGHT 2 and 1 (loop, clips/s, middle
                   frames/s, the forward's device share, host seconds).
  8. train_golden — two f32 training steps of TAI_gray at B=2 against the JAX
                   training golden (``tests/torch_golden_train_tai_gray.npz``):
                   loss terms within rel 1e-3, step-1 gradient projections
                   within global-L2-relative 1e-3.
  9. train_kernel_vs_plain — the G gradient through the adjoint kernels
                   against the same gradient through the plain adjoints,
                   global-L2-relative <= 1e-4.
 10. train_pallas — one f32 G update of TAI_gray at B=2 through each forward
                   kernel: G gradients within global-L2-relative 1e-3.
 11. train       — TAI_gray B=8 in bf16 mixed precision and in f32: finite
                   loss terms, 2 launches of the banded forward and of each
                   adjoint per G update, ms per step (G and D updates apart)
                   and peak device memory.
 12. train_color — TAI_color 256x320 B=4 in bf16: the same counts and times.
 13. train_cli   — TAI_gray at the KTH configuration (the KTH argfiles, their
                   videolists replaced by synthetic .npy clips: 64 training
                   clips of 15 frames, 16 for each validation set at 15, 20
                   and 19 frames) through ``vfi_tpu_torch.cli.train`` from a
                   port snapshot at updates=0 of the seed-0 weights: bf16
                   ``--device_normalize`` ``--sample_KTF`` B=8, 30 iterations
                   (snapshots every 10, validation every 15), then a resume
                   to 40; 40 finite ``iter`` events, resumes at 0 and 30, 6
                   ``val`` events, a ``best`` one, the snapshots, and the
                   launches of the run's own schedule (2+2+2 per G update, 2
                   banded per validation or visualisation forward, 0
                   direct).  Then the CLI in f32 at B=2 (data in order,
                   fixed K, T, F) against ``TAIEnvironment.train_step`` on the
                   same batches (rel 1e-3) with the TF32 flags put back; a
                   run on the direct kernel's route (a JSON key with
                   ``"sepconv_impl": "pallas"``); and ``--remat`` against the
                   same two iterations without it (the same launches, step-1
                   terms within rel 1e-3, peak memory of each).
 14. timing_train_cli — the train CLI at B=8 bf16 ``--device_normalize`` from
                   a fresh init, 10 warm-up and 50 timed iterations at
                   ``--print_freq 10``, at fixed K=T=F=5 and under
                   ``--sample_KTF``: ms/it (median of the print windows after
                   the first) beside ``train``'s ms per step, the host's
                   seconds (prefetcher, copy and normalise, step dispatch,
                   sync at print), one validation sweep and one snapshot save.
 15. timing      — CUDA-event times of each kernel, its plain version and the
                   serving forwards (the forwards at both serving and both
                   training shapes, the adjoints at both training shapes;
                   with ``--baseline``, another checkout's four kernels in
                   turns with these); a ``kernels`` line with each kernel's
                   numbers.

Prints the card's name and power limit (nvidia-smi) on the line before the
last, and as the last line ``{"ok": true, "device": {...}}``.  Any failed gate
exits non-zero before that line.  Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from vfi_tpu_torch.api import VideoInpainter
from vfi_tpu_torch.cli import compute_quant_results as quant_cli
from vfi_tpu_torch.cli import predict as predict_cli
from vfi_tpu_torch.cli import train as train_cli
from vfi_tpu_torch.data import native_loader
from vfi_tpu_torch.data.datasets import ContiguousVideoClipDataset, batch_iterator
from vfi_tpu_torch.data.synthetic import make_videolist
from vfi_tpu_torch.models.registry import create_model, model_config
from vfi_tpu_torch.ops import _kernels
from vfi_tpu_torch.ops import sepconv as sepconv_ops
from vfi_tpu_torch.train.environments import L2GDLDiscEnvironment, create_training_environment
from vfi_tpu_torch.utils import checkpoint as ckpt
from vfi_tpu_torch.utils.config import TrainConfig
from vfi_tpu_torch.utils.png import read_png, write_png
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
# The adjoints' main-path shapes (B*T, H, W, C): TAI_gray training at B=8,
# TAI_color 256x320 training at B=4.
ADJOINT_SHAPES = {"gray_train": (40, 128, 128, 1), "color_train": (20, 256, 320, 3)}


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
        (20, 256, 320, 3, KS, False),  # TAI_color training, B=4
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
            if (BT, H, W, C) in ADJOINT_SHAPES.values():
                errs.update(_adjoint_vs_emulation(x, v, h, g, got_x, got_v, got_h, (BT, H, W, C, ks)))
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
# The same for the adjoints' emulations (they hold every row's slab and band).
ADJOINT_EMULATED_IMAGES = 2


def _adjoint_vs_emulation(x, v, h, g, got_x, got_v, got_h, shape) -> dict:
    """Both adjoint kernels' outputs against the emulations of their tiling
    (``_sepconv_bwd_vh_tiled``, ``_sepconv_bwd_x_tiled``) on the first
    ``ADJOINT_EMULATED_IMAGES`` images: the same products summed in another
    order, so f32 within 1e-5 * max(1, max|emulation|) and bf16 within one
    bf16 ulp of the emulation's result."""
    n = ADJOINT_EMULATED_IMAGES
    emul_v, emul_h = sepconv_ops._sepconv_bwd_vh_tiled(x[:n], v[:n], h[:n], g[:n])
    emul_x = sepconv_ops._sepconv_bwd_x_tiled(v[:n], h[:n], g[:n])
    errs = {}
    for name, got, emul in (("grad_v", got_v, emul_v), ("grad_h", got_h, emul_h), ("grad_x", got_x, emul_x)):
        kernel = "sepconv_bwd_x" if name == "grad_x" else "sepconv_bwd_vh"
        diff = (got[:n].float() - emul.float()).abs()
        if x.dtype == torch.float32:
            err = float(diff.max())
            errs[(kernel, name, "f32_vs_emulation_max_abs")] = err
            gate(err <= 1e-5 * max(1.0, float(emul.abs().max())),
                 f"{kernel} {name} f32 {shape}: {err} off the emulation of its tiling")
        else:
            ulps = float((diff / bf16_ulp(emul.float())).max())
            errs[(kernel, name, "bf16_vs_emulation_max_ulps")] = ulps
            gate(ulps <= 1.0, f"{kernel} {name} bf16 {shape}: {ulps} bf16 ulps off the emulation of its tiling")
    return errs


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
        (2, 37, 137, 3, KS),  # ragged at the full tap count: W a multiple of neither kernel's column tile
        (2, 19, 40, 4, KS),  # four channels at the full tap count (the banded f32 tiles: 4 rows a block)
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


# The predict phase: TAI_gray served by the predict CLI from a snapshot.
PREDICT = dict(model_key="TAI_gray", param_seed=0, clip_seed=0, clips=130, frames=15, hw=128, K=5, T=5, F=5,
               batch=64, f32_clips=16, f32_batch=8, pallas_clips=8)
PREDICT_NAME = "smoke_tai_gray"


def _head(videolist: str, n: int, path: str) -> str:
    """A videolist of the first ``n`` lines of ``videolist``."""
    with open(videolist) as f, open(path, "w") as g:
        g.writelines(f.readlines()[:n])
    return path


def run_predict(args) -> tuple[dict, str]:
    """``vfi_tpu_torch.cli.predict.main(args)`` in this process; (its stats, its stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        stats = predict_cli.main(args)
    return stats, out.getvalue()


def np_psnr_ssim(pred: np.ndarray, gt: np.ndarray, win: int = 7) -> tuple[float, float]:
    """PSNR and SSIM of two uint8 images [H, W] or [H, W, C] in float64 numpy,
    skimage's semantics (data_range 255; SSIM: 7x7 uniform VALID window, sample
    covariance, mean over channels and valid pixels); an independent reference
    for ``ops/metrics.py``."""
    x, y = (a.astype(np.float64).reshape(a.shape[0], a.shape[1], -1) for a in (pred, gt))
    psnr = 10.0 * math.log10(255.0**2 / max(float(np.mean((x - y) ** 2)), 1e-12))

    def win_mean(a):
        c = np.pad(a, ((1, 0), (1, 0), (0, 0))).cumsum(0).cumsum(1)
        return (c[win:, win:] - c[:-win, win:] - c[win:, :-win] + c[:-win, :-win]) / (win * win)

    n = win * win
    ux, uy = win_mean(x), win_mean(y)
    vx = n / (n - 1) * (win_mean(x * x) - ux * ux)
    vy = n / (n - 1) * (win_mean(y * y) - uy * uy)
    vxy = n / (n - 1) * (win_mean(x * y) - ux * uy)
    c1, c2 = (0.01 * 255.0) ** 2, (0.03 * 255.0) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
    return psnr, float(s.mean())


def _predict_args(cfg, root, videolist, qual, dtype, batch, extra=()):
    return ["--K", str(cfg["K"]), "--T", str(cfg["T"]), "--F", str(cfg["F"]), "--c_dim", "1",
            "--image_size", str(cfg["hw"]), "--batch_size", str(batch), "--dtype", dtype,
            "--model_key", cfg["model_key"], "--name", PREDICT_NAME, "--checkpoints_dir", os.path.join(root, "ckpt"),
            "--test_video_list_path", videolist, "--qual_result_root", qual, "--device", "cuda", *extra]


def _pngs(qual: str) -> dict:
    return {clip: sorted(os.listdir(os.path.join(qual, clip))) for clip in sorted(os.listdir(qual))}


def phase_predict(root: str) -> tuple:
    """TAI_gray served by ``vfi_tpu_torch.cli.predict`` from a port snapshot
    of ``random_jax_params("TAI_gray", 0)`` on 130 synthetic clips of exactly
    K+T+F = 15 frames (so the crop is deterministic), the metrics by
    ``cli.compute_quant_results`` on the card.  Returns the launches of its
    three paths and the data the timing needs."""
    cfg = PREDICT
    K, T, F = cfg["K"], cfg["T"], cfg["F"]
    videolist = make_videolist(os.path.join(root, "clips"), cfg["clips"], cfg["clip_seed"], n_frames=cfg["frames"],
                               hw=cfg["hw"])
    env = create_training_environment(create_model(cfg["model_key"]), TrainConfig(K=K, T=T, F=F))
    state = env.init_state((cfg["hw"], cfg["hw"]), g_params=random_jax_params(cfg["model_key"], cfg["param_seed"]),
                           device="cpu")
    ckpt.save_snapshot(os.path.join(root, "ckpt", PREDICT_NAME), "model_best.ckpt", state,
                       {"updates": 0, "sum_avg_psnr_err": 0.0, "sum_avg_ssim_err": 0.0})
    del env, state

    # Host decoding: the .npy clips are read by numpy; the native loader
    # (frame directories) is built here and held to the Python path.
    native = native_loader.available()
    native_err = None
    if native:
        vid = np.load(os.path.join(root, "clips", "clip0.npy"))
        frames_dir = os.path.join(root, "frames0")
        os.makedirs(frames_dir, exist_ok=True)
        for t, frame in enumerate(vid):
            write_png(os.path.join(frames_dir, f"{t:04d}.png"), frame)
        lst = os.path.join(root, "frames.txt")
        with open(lst, "w") as f:
            f.write(f"{frames_dir} 1-{cfg['frames']}\n")
        py, nat = (ContiguousVideoClipDataset(1, lst, cfg["frames"], False, False, (cfg["hw"], cfg["hw"]), False,
                                              use_native=u)[0]["targets"] for u in (False, True))
        native_err = float(np.abs(py - nat).max())
        # The luma weights sum to 0.9999: the native loader applies them before
        # the map to [-1, 1], the Python path after it, 1e-4 apart (as in vfi_tpu).
        gate(native_err <= 2e-4, f"native loader off the Python path by {native_err} on PNG frames at the model's size")
    emit("predict_decoder", clips="numpy .npy (datasets._VideoReader)", native_loader_available=native,
         native_vs_python_max_abs=native_err)

    paths, res = {}, {}
    # bf16, --device_normalize, B=64: batches of 64, 64 and 2 (padded to 64).
    qual16 = os.path.join(root, "qual_bf16")
    _reset_launch_counts()
    stats, stdout = run_predict(_predict_args(cfg, root, videolist, qual16, "bfloat16", cfg["batch"],
                                              ["--device_normalize"]))
    paths["predict"] = _launch_counts()
    pngs = _pngs(qual16)
    n_pad = stdout.count(f"padded final batch {cfg['clips'] % cfg['batch']} -> {cfg['batch']}")
    emit("predict", dtype="bfloat16", batch=cfg["batch"], clips=stats["clips"], batches=stats["batches"],
         folders=len(pngs), pngs_per_folder=sorted({len(v) for v in pngs.values()}), padding_lines=n_pad,
         loop_s=stats["loop_s"], forward_s=stats["forward_s"], **paths["predict"])
    gate(len(pngs) == cfg["clips"] and all(len(v) == K + 2 * T + F for v in pngs.values()),
         f"predict bf16 wrote {len(pngs)} folders of {sorted({len(v) for v in pngs.values()})} PNGs")
    gate(n_pad == 1, f"the padding line was printed {n_pad} times")
    _gate_launches("predict", paths["predict"], {"sepconv_fwd_mxu": 6})

    # f32 (TF32 off) on the first 16 clips at B=8, against from_checkpoint(...).inpaint.
    qual32 = os.path.join(root, "qual_f32")
    lst16 = _head(videolist, cfg["f32_clips"], os.path.join(root, "list16.txt"))
    _reset_launch_counts()
    stats32, _ = run_predict(_predict_args(cfg, root, lst16, qual32, "float32", cfg["f32_batch"]))
    paths["predict_f32"] = _launch_counts()
    _gate_launches("predict_f32", paths["predict_f32"],
                   {"sepconv_fwd_mxu": 2 * (cfg["f32_clips"] // cfg["f32_batch"])})
    with uncounted():
        ip = VideoInpainter.from_checkpoint(cfg["model_key"], os.path.join(root, "ckpt", PREDICT_NAME),
                                            dtype=torch.float32, device="cuda")
        vids = np.stack([np.load(os.path.join(root, "clips", f"clip{i}.npy")) for i in range(cfg["f32_clips"])])
        want = ip.inpaint(vids[:, :K], vids[:, K + T:], T)[..., 0]
        del ip
    worst, psnr16 = 0, []
    for i in range(cfg["f32_clips"]):
        label = f"clip{i}.npy_1-{cfg['frames']}"
        for t in range(T):
            name = f"pred_middle_{K + t:04d}.png"
            got = read_png(os.path.join(qual32, label, name))
            worst = max(worst, int(np.abs(got.astype(np.int16) - want[i, t]).max()))
            psnr16.append(u8_psnr(read_png(os.path.join(qual16, label, name)), got))
    res.update(f32_vs_inpaint_max_levels=worst, bf16_vs_f32_u8_psnr_db_min=min(psnr16),
               bf16_vs_f32_u8_psnr_db_mean=float(np.mean(psnr16)))
    gate(worst <= 1, f"predict f32 PNGs off from_checkpoint(...).inpaint by {worst} uint8 levels")

    # Metrics on the card against float64 numpy.
    quant = os.path.join(root, "quant_f32")
    with contextlib.redirect_stdout(io.StringIO()):
        quant_cli.main([qual32, quant, str(K), str(T)])
    z = np.load(os.path.join(quant, "results.npz"))
    ref = np.array([[np_psnr_ssim(read_png(os.path.join(v, f"pred_middle_{t:04d}.png")),
                                  read_png(os.path.join(v, f"gt_middle_{t:04d}.png"))) for t in range(K, K + T)]
                    for v in z["video"]])
    dpsnr = float(np.abs(z["psnr"] - ref[..., 0]).max())
    dssim = float(np.abs(z["ssim"] - ref[..., 1]).max())
    res.update(quant_videos=len(z["video"]), quant_psnr_mean_db=float(z["psnr"].mean()),
               quant_ssim_mean=float(z["ssim"].mean()), quant_psnr_max_abs_diff_db=dpsnr,
               quant_ssim_max_abs_diff=dssim)
    gate(z["psnr"].shape == (cfg["f32_clips"], T), f"results.npz psnr of shape {z['psnr'].shape}")
    gate(dpsnr <= 1e-3, f"card PSNR off the float64 reference by {dpsnr} dB > 1e-3")
    gate(dssim <= 1e-4, f"card SSIM off the float64 reference by {dssim} > 1e-4")

    # The direct kernel's route, named by a JSON model key.
    spec = {**model_spec(cfg["model_key"], "pallas"), "args": []}
    lst8 = _head(videolist, cfg["pallas_clips"], os.path.join(root, "list8.txt"))
    _reset_launch_counts()
    run_predict(_predict_args(cfg, root, lst8, os.path.join(root, "qual_pallas"), "bfloat16", cfg["pallas_clips"],
                              ["--model_key", json.dumps(spec), "--device_normalize"]))  # the later key wins
    paths["predict_pallas"] = _launch_counts()
    _gate_launches("predict_pallas", paths["predict_pallas"], {"sepconv_fwd": 2})
    emit("predict_checks", f32_launches=paths["predict_f32"], pallas_launches=paths["predict_pallas"],
         pallas_model_key=spec, **res)
    return paths, (videolist, stats)


def phase_timing_predict(root: str, videolist: str, warm: dict) -> None:
    """The bf16 B=64 predict run of ``phase_predict`` (its warm-up) timed again
    at VFI_INFLIGHT 2 and 1: the loop's wall seconds, clips/s and middle
    frames/s through the CLI, the forward's device seconds (CUDA events around
    ``forward_test``) against the host's: waiting for decoded batches, and
    writing PNGs, split into waiting for the device, normalizing the GT frames
    and the rest (quantizing and encoding the PNGs, writing the files)."""
    cfg = PREDICT
    runs = {}
    saved = os.environ.get("VFI_INFLIGHT")
    try:
        for depth in (2, 1):
            os.environ["VFI_INFLIGHT"] = str(depth)
            qual = os.path.join(root, f"qual_timing_{depth}")
            with uncounted():
                stats, _ = run_predict(_predict_args(cfg, root, videolist, qual, "bfloat16", cfg["batch"],
                                                     ["--device_normalize"]))
            shutil.rmtree(qual)
            runs[depth] = stats
            middles = stats["clips"] * cfg["T"]
            emit("timing_predict", model=cfg["model_key"], dtype="bfloat16", batch=cfg["batch"],
                 device_normalize=True, inflight=depth, clips=stats["clips"], batches=stats["batches"],
                 loop_s=stats["loop_s"], clips_per_s=stats["clips"] / stats["loop_s"],
                 middle_frames_per_s=middles / stats["loop_s"], forward_s=stats["forward_s"],
                 forward_share=stats["forward_s"] / stats["loop_s"],
                 forward_ms_per_batch=stats["forward_s"] / stats["batches"] * 1e3,
                 forward_only_middle_frames_per_s=middles / stats["forward_s"],
                 wait_data_s=stats["wait_data_s"], write_s=stats["write_s"], wait_device_s=stats["wait_device_s"],
                 normalize_s=stats["normalize_s"],
                 png_s=stats["write_s"] - stats["wait_device_s"] - stats["normalize_s"],
                 warmup_loop_s=warm["loop_s"], pngs_per_batch=cfg["batch"] * (cfg["K"] + 2 * cfg["T"] + cfg["F"]))
    finally:
        if saved is None:
            os.environ.pop("VFI_INFLIGHT", None)
        else:
            os.environ["VFI_INFLIGHT"] = saved


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
    return warmup + timed + split, step_ms


def _expect_train(n_g_updates: int) -> dict:
    return {"sepconv_fwd_mxu": 2 * n_g_updates, "sepconv_bwd_vh": 2 * n_g_updates, "sepconv_bwd_x": 2 * n_g_updates}


def phase_train(gen) -> tuple[dict, float]:
    """TAI_gray training at full width, B=8, bf16 mixed precision then f32:
    3 warm-up steps, 5 timed steps, 3 steps with the G and D updates timed
    apart.  Returns each kernel's launches in this path's run and the bf16
    ms per step."""
    _reset_launch_counts()
    runs = {dtype: _train_run("TAI_gray", 8, 128, 128, 1, dtype, gen, 3, 5, 3) for dtype in ("bfloat16", "float32")}
    n_g_updates = sum(n for n, _ in runs.values())
    launches = _launch_counts()
    emit("train_launches", model="TAI_gray", g_updates=n_g_updates, **launches)
    _gate_launches("train", launches, _expect_train(n_g_updates))
    return launches, runs["bfloat16"][1]


def phase_train_color(gen) -> dict:
    """TAI_color at 256x320, B=4, bf16 mixed precision: 1 warm-up step, then
    3 steps with the G and D updates timed apart."""
    _reset_launch_counts()
    n_g_updates, _ = _train_run("TAI_color", 4, 256, 320, 3, "bfloat16", gen, 1, 0, 3)
    launches = _launch_counts()
    emit("train_color_launches", model="TAI_color", g_updates=n_g_updates, **launches)
    _gate_launches("train_color", launches, _expect_train(n_g_updates))
    return launches


# The train_cli phase: TAI_gray at the KTH configuration (exp_args/*/KTH) through
# the train CLI, from a port snapshot of random_jax_params("TAI_gray", 0).
TRAIN_CLI = dict(model_key="TAI_gray", param_seed=0, disc_seed=3, clip_seed=20, hw=128, K=5, T=5, F=5, alt_T=10,
                 alt_K=7, alt_F=7, train_clips=64, val_clips=16, batch=8)
KTH_ARGS = ("@" + os.path.join(REPO, "exp_args", "default_args", "KTH", "train.txt"),
            "@" + os.path.join(REPO, "exp_args", "extra_args", "KTH", "bi-TAI.txt"))
# The same configuration at fixed K, T, F (train.txt turns --sample_KTF on, and
# a store_true flag cannot be turned off after it).
KTH_FIXED_ARGS = (*(a for k in ("K", "T", "F", "alt_K", "alt_T", "alt_F") for a in (f"--{k}", str(TRAIN_CLI[k]))),
                  "--c_dim", "1", "--image_size", str(TRAIN_CLI["hw"]), "--model_key", TRAIN_CLI["model_key"])


def run_train(args) -> tuple[dict, str]:
    """``vfi_tpu_torch.cli.train.main(args)`` in this process; (its stats, its stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        stats = train_cli.main(args)
    return stats, out.getvalue()


def _train_cli_lists(root: str) -> dict:
    """Synthetic .npy clips in place of the KTH videolists: 64 training clips
    of K+T+F = 15 frames and 16 clips for each validation set at its own
    length (15, 20 and 19 frames); the visualisation lists are the
    validation lists.  {flag: videolist}."""
    c = TRAIN_CLI
    K, T, F = c["K"], c["T"], c["F"]

    def clips(name, n, frames, seed):
        return make_videolist(os.path.join(root, name), n, seed, n_frames=frames, hw=c["hw"])

    val = {"": clips("val", c["val_clips"], K + T + F, c["clip_seed"] + 1),
           "_alt_T": clips("val_alt_T", c["val_clips"], K + c["alt_T"] + F, c["clip_seed"] + 2),
           "_alt_K_F": clips("val_alt_K_F", c["val_clips"], c["alt_K"] + T + c["alt_F"], c["clip_seed"] + 3)}
    return {"--train_video_list_path": clips("train", c["train_clips"], K + T + F, c["clip_seed"]),
            **{f"--val_video_list{k}_path": v for k, v in val.items()},
            **{f"--vis_video_list{k}_path": v for k, v in val.items()}}


def _train_cli_args(root: str, name: str, lists: dict, *extra: str, base=KTH_ARGS) -> list:
    return [*base, *(a for kv in lists.items() for a in kv), "--name", name, "--batch_size", str(TRAIN_CLI["batch"]),
            "--checkpoints_dir", os.path.join(root, "ckpt"), "--tensorboard_dir", os.path.join(root, "tb"),
            "--log_json", os.path.join(root, f"{name}.jsonl"), *extra]


def _events(root: str, name: str, kind: str) -> list:
    with open(os.path.join(root, f"{name}.jsonl")) as f:
        return [e for e in map(json.loads, f) if e["event"] == kind]


def _start_snapshot(root: str, name: str) -> None:
    """The start snapshot (``<root>/start``, updates 0) as ``<root>/ckpt/<name>/model_latest.ckpt``."""
    shutil.copytree(os.path.join(root, "start", "model_latest.ckpt"),
                    os.path.join(root, "ckpt", name, "model_latest.ckpt"))


@contextlib.contextmanager
def step_peak_memory(record: list):
    """Appends the peak device memory of each ``train_step`` run inside to
    ``record`` (a CLI's visualisation and validation forwards left out).
    Synchronises around each step: for untimed runs only."""
    real = L2GDLDiscEnvironment.train_step

    def measured(self, *args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = real(self, *args, **kwargs)
        torch.cuda.synchronize()
        record.append(torch.cuda.max_memory_allocated())
        return out

    L2GDLDiscEnvironment.train_step = measured
    try:
        yield record
    finally:
        L2GDLDiscEnvironment.train_step = real


@contextlib.contextmanager
def no_tensorboard():
    """``torch.utils.tensorboard`` unimportable inside, so the train CLI runs without a writer."""
    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if k.startswith("torch.utils.tensorboard")}
    sys.modules["torch.utils.tensorboard"] = None
    try:
        yield
    finally:
        del sys.modules["torch.utils.tensorboard"]
        sys.modules.update(saved)


def _cli_forwards(stats: dict, iters: int, val_events: int) -> int:
    """Visualisation forwards of a CLI run at --print_freq 1: a train_vis grid
    per iteration and a sample grid per validation set swept, where a
    TensorBoard writer exists (none on a machine without tensorboard)."""
    return iters + val_events if stats["tensorboard"] else 0


def phase_train_cli(root: str, lists: dict) -> dict:
    """TAI_gray at the KTH configuration through ``vfi_tpu_torch.cli.train``:
    the KTH run (bf16, --device_normalize, --sample_KTF, B=8: 30 iterations,
    then a resume to 40), an f32 run against ``TAIEnvironment.train_step``
    driven directly, the direct kernel's route, and --remat against the same
    run without it.  Returns the launches of each of these paths."""
    c = TRAIN_CLI
    hw, B = c["hw"], c["batch"]
    cfg = TrainConfig(K=c["K"], T=c["T"], F=c["F"])
    env = create_training_environment(create_model(c["model_key"]), cfg)
    state = env.init_state((hw, hw), g_params=random_jax_params(c["model_key"], c["param_seed"]),
                           d_variables=random_jax_disc_variables(cfg, hw, hw, 1, c["disc_seed"]), device="cpu")
    ckpt.save_snapshot(os.path.join(root, "start"), "model_latest.ckpt", state,
                       {"updates": 0, "sum_avg_psnr_err": 0.0, "sum_avg_ssim_err": 0.0})
    del env, state
    paths = {}
    bf16 = ("--train_dtype", "bfloat16", "--device_normalize", "--print_freq", "1")

    # The KTH run: snapshots every 10, validation every 15, resumed at 30.
    _start_snapshot(root, "kth")
    freq = ("--save_latest_freq", "10", "--validate_freq", "15")
    _reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    stats = [run_train(_train_cli_args(root, "kth", lists, *bf16, *freq, "--max_iter", str(n)))[0] for n in (30, 40)]
    paths["train_cli"] = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    iters = _events(root, "kth", "iter")
    vals = _events(root, "kth", "val")
    resumes = [e["iter"] for e in _events(root, "kth", "resume")]
    bests = [e["iter"] for e in _events(root, "kth", "best")]
    saves = _events(root, "kth", "save")
    snapshots = sorted(os.listdir(os.path.join(root, "ckpt", "kth")))
    _, counters = ckpt.load_snapshot(os.path.join(root, "ckpt", "kth"), "model_latest.ckpt")
    g_updates = sum(s["iters"] for s in stats)
    val_batches = sum(math.ceil(c["val_clips"] / B) for _ in vals)
    vis = sum(_cli_forwards(s, s["iters"], 3 * len(s["val_s"])) for s in stats)
    want = {"sepconv_fwd_mxu": 2 * (g_updates + val_batches + vis), "sepconv_bwd_vh": 2 * g_updates,
            "sepconv_bwd_x": 2 * g_updates}
    finite = all(math.isfinite(e[k]) for e in iters for k in TERM_NAMES)
    ktf = [(e["K"], e["T"], e["F"]) for e in iters]
    emit("train_cli", model=c["model_key"], dtype="bfloat16", batch=B, args=list(KTH_ARGS), iters=len(iters),
         resumes=resumes, val_events=[(e["iter"], e["tag"], e["psnr"], e["ssim"]) for e in vals], best_iters=bests,
         save_s=[e["seconds"] for e in saves], snapshots=snapshots, latest_updates=counters["updates"],
         g_updates=g_updates, val_batches=val_batches, tensorboard=stats[0]["tensorboard"],
         visualisation_forwards=vis, launches=paths["train_cli"], want_launches=want, finite_terms=finite,
         mean_T=float(np.mean([k[1] for k in ktf])), distinct_KTF=len(set(ktf)), max_memory_allocated_bytes=peak,
         last_terms={k: iters[-1][k] for k in TERM_NAMES})
    print(f"train_cli: TensorBoard writer {'present' if stats[0]['tensorboard'] else 'absent'} on this machine, "
          f"so {vis} visualisation forwards", flush=True)
    gate([e["iter"] for e in iters] == list(range(1, 41)), f"train_cli logged iterations {[e['iter'] for e in iters]}")
    gate(finite, "train_cli: non-finite loss terms")
    gate(resumes == [0, 30], f"train_cli resume events at {resumes}, want [0, 30]")
    gate(len(vals) == 6 and bests, f"train_cli: {len(vals)} val events, best at {bests}")
    gate({"model_latest.ckpt", "model_00000010.ckpt", "model_00000020.ckpt", "model_00000030.ckpt",
          "model_00000040.ckpt", "model_best.ckpt"} <= set(snapshots), f"train_cli snapshots {snapshots}")
    gate(counters["updates"] == 40, f"model_latest.ckpt at updates {counters['updates']}")
    gate(len(set(ktf)) > 1, "train_cli: --sample_KTF sampled one (K, T, F)")
    _gate_launches("train_cli", paths["train_cli"], want)
    shutil.rmtree(os.path.join(root, "ckpt", "kth"))  # 493 MB a snapshot at TAI_gray

    # f32 (TF32 off) at B=2, the data in order, against train_step driven directly.
    _start_snapshot(root, "f32")
    tf32_before = (True, True)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_before
    try:
        _reset_launch_counts()
        stats, stdout = run_train(_train_cli_args(
            root, "f32", lists, "--batch_size", "2", "--train_dtype", "float32", "--serial_batches",
            "--no_backwards", "--no_flip", "--num_threads", "0", "--max_iter", "2", "--print_freq", "1",
            "--save_latest_freq", "100", "--validate_freq", "100", base=KTH_FIXED_ARGS))
        paths["train_cli_f32"] = _launch_counts()
        tf32_after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cli_terms = _events(root, "f32", "iter")
    ds = ContiguousVideoClipDataset(1, lists["--train_video_list_path"], c["K"] + c["T"] + c["F"], False, False,
                                    (hw, hw), True)
    env = create_training_environment(create_model(c["model_key"]), cfg)
    direct = []
    with uncounted():
        state, _ = ckpt.load_snapshot(os.path.join(root, "start"), "model_latest.ckpt",
                                      env.init_state((hw, hw), device="cuda"))
        for first in (2, 4):  # the init batch is clips 0-1
            batch = np.stack([ds[i]["targets"] for i in (first, first + 1)])
            state, m = env.train_step(state, c["K"], c["T"], c["F"], batch)
            direct.append({k: float(v) for k, v in m.items()})
    del env, state
    rel = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12) for g, w in zip(cli_terms, direct) for k in TERM_NAMES)
    emit("train_cli_f32", dtype="float32", batch=2, iters=len(cli_terms), terms_max_rel_vs_train_step=rel,
         tf32_printed="TF32: matmul False, cudnn False" in stdout, tf32_restored=tf32_after == tf32_before,
         launches=paths["train_cli_f32"])
    gate(len(cli_terms) == 2 and rel <= 1e-3, f"train CLI f32 terms off train_step by rel {rel} > 1e-3")
    gate(tf32_after == tf32_before and "TF32: matmul False, cudnn False" in stdout,
         f"train CLI left TF32 at {tf32_after}, or did not run with it off")
    _gate_launches("train_cli_f32", paths["train_cli_f32"],
                   {"sepconv_fwd_mxu": 2 * (2 + _cli_forwards(stats, 2, 0)), "sepconv_bwd_vh": 4, "sepconv_bwd_x": 4})

    # The direct kernel's route, named by a JSON model key (the later key wins).
    _start_snapshot(root, "pallas")
    spec = {**model_spec(c["model_key"], "pallas"), "args": []}
    nofreq = ("--save_latest_freq", "100", "--validate_freq", "100", "--max_iter", "2")
    _reset_launch_counts()
    stats, _ = run_train(_train_cli_args(root, "pallas", lists, *bf16, *nofreq, "--model_key", json.dumps(spec)))
    paths["train_cli_pallas"] = _launch_counts()
    emit("train_cli_pallas", model_key=spec, launches=paths["train_cli_pallas"])
    _gate_launches("train_cli_pallas", paths["train_cli_pallas"],
                   {"sepconv_fwd": 2 * (2 + _cli_forwards(stats, 2, 0)), "sepconv_bwd_vh": 4, "sepconv_bwd_x": 4})

    # --remat against the same two iterations without it, at fixed K=T=F=5 (one
    # loader thread, so the same data); peak memory of the training steps.
    runs = {}
    for remat in (False, True):
        name = f"remat_{remat}"
        _start_snapshot(root, name)
        torch.cuda.empty_cache()
        _reset_launch_counts()
        with step_peak_memory([]) as peaks:
            stats, _ = run_train(_train_cli_args(root, name, lists, *bf16, *nofreq, "--num_threads", "0",
                                                 *(["--remat"] if remat else []), base=KTH_FIXED_ARGS))
        runs[remat] = (_launch_counts(), max(peaks), _events(root, name, "iter")[0], stats)
    paths["train_cli_remat"] = runs[True][0]
    rel = max(abs(runs[True][2][k] - runs[False][2][k]) / max(abs(runs[False][2][k]), 1e-12) for k in TERM_NAMES)
    emit("train_cli_remat", dtype="bfloat16", batch=B, K=c["K"], T=c["T"], F=c["F"], launches_remat=runs[True][0],
         launches_without=runs[False][0], step1_terms_max_rel=rel, step_peak_memory_bytes_remat=runs[True][1],
         step_peak_memory_bytes_without=runs[False][1])
    gate(runs[True][0] == runs[False][0], f"--remat changed the launches: {runs[True][0]} vs {runs[False][0]}")
    _gate_launches("train_cli_remat", runs[True][0], {"sepconv_fwd_mxu": 2 * (2 + _cli_forwards(runs[True][3], 2, 0)),
                                                      "sepconv_bwd_vh": 4, "sepconv_bwd_x": 4})
    gate(rel <= 1e-3, f"--remat step-1 terms off the run without it by rel {rel} > 1e-3")
    return paths


def phase_timing_train_cli(root: str, lists: dict, train_ms: float) -> None:
    """The train CLI timed: TAI_gray B=8 bf16 --device_normalize from a fresh
    init, 10 warm-up and 50 timed iterations at --print_freq 10, at fixed
    K=T=F=5 and under --sample_KTF.  ms/it is the median of the print windows
    after the first, beside the ``train`` phase's ms per step (the step alone
    on one fixed batch); the host's seconds: waiting for the prefetcher,
    copying and normalising, dispatching the steps, the sync at each print;
    one validation sweep and one snapshot save at iteration 60; where a
    TensorBoard writer exists, the seconds of the train_vis grids (left out
    of ms/it, as snapshots and validation are).  Two more runs at fixed
    K, T, F split the loop's cost: without a TensorBoard writer, and without
    a writer from 8 batches cached on the device (no host data work)."""
    c = TRAIN_CLI
    ds = ContiguousVideoClipDataset(1, lists["--train_video_list_path"], c["K"] + c["T"] + c["F"], True, True,
                                    (c["hw"], c["hw"]), True, emit_uint8=True)
    batches = batch_iterator(ds, c["batch"], True, True, seed=0, loop=True)
    t0 = time.perf_counter()
    for _ in range(8):
        next(batches)
    emit("timing_train_cli_decode", clips="numpy .npy", batch=c["batch"], device_normalize=True,
         host_ms_per_batch=(time.perf_counter() - t0) / 8 * 1e3)
    every = ("--save_latest_freq", "60", "--validate_freq", "60")
    never = ("--save_latest_freq", "1000", "--validate_freq", "1000")
    modes = (("fixed", KTH_FIXED_ARGS, every, False), ("sample_KTF", KTH_ARGS, every, False),
             ("fixed_no_writer", KTH_FIXED_ARGS, never, True),
             ("fixed_no_writer_device_cache", KTH_FIXED_ARGS, never + ("--device_cache", "8"), True))
    for mode, base, extra, blind in modes:
        name = f"timing_{mode}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with uncounted(), (no_tensorboard() if blind else contextlib.nullcontext()):
            stats, _ = run_train(_train_cli_args(
                root, name, lists, "--train_dtype", "bfloat16", "--device_normalize", "--max_iter", "60",
                "--print_freq", "10", *extra, base=base))
        windows = [e["ms_per_it"] for e in _events(root, name, "iter")]
        ms = float(np.median(windows[1:]))
        rng = np.random.RandomState(0)  # the CLI's --seed: its (K, T, F) draws
        T_all = [c["T"]] * 60 if mode == "fixed" else [
            (rng.randint(2, c["K"] + 1), rng.randint(1, c["T"] + 1), rng.randint(2, c["F"] + 1))[1] for _ in range(60)]
        n = stats["iters"]
        emit("timing_train_cli", model=c["model_key"], mode=mode, dtype="bfloat16", batch=c["batch"],
             device_normalize=True, iters=n, ms_per_it=ms, iterations_per_s=1e3 / ms, ms_per_it_windows=windows,
             train_phase_ms_per_step=train_ms, over_train_phase=ms / train_ms - 1.0 if train_ms else None,
             mean_T_timed=float(np.mean(T_all[10:])),
             wait_data_s=stats["wait_data_s"], prep_s=stats["prep_s"], step_s=stats["step_s"],
             sync_s=stats["sync_s"], host_ms_per_it={k: stats[k] / n * 1e3 for k in
                                                     ("wait_data_s", "prep_s", "step_s", "sync_s")},
             tensorboard=stats["tensorboard"], train_vis_s=stats["vis_s"],
             val_sweep_s=stats["val_s"][0] if stats["val_s"] else None,
             save_s=next((e["seconds"] for e in _events(root, name, "save")), None),
             max_memory_allocated_bytes=torch.cuda.max_memory_allocated())


# The forwards' main-path shapes (B*T, H, W, C): TAI_gray serving at B=64 and
# training at B=8, TAI_color serving at B=16 and training at B=4.
FORWARD_SHAPES = {"gray": (320, 128, 128, 1), "gray_train": (40, 128, 128, 1), "color": (80, 256, 320, 3),
                  "color_train": (20, 256, 320, 3)}


def timed_in_turns(kernel, args, baseline=None, iters=10):
    """(ms, baseline_ms) of ``kernel(*args)``, launches uncounted; with a
    ``baseline`` callable the two are timed in turns (baseline, kernel,
    kernel, baseline) and each time is the mean of its two turns, else
    baseline_ms is None."""
    with uncounted():
        if baseline is None:
            return cuda_ms(lambda: kernel(*args), iters=iters), None
        b0 = cuda_ms(lambda: baseline(*args), iters=iters)
        ms = (cuda_ms(lambda: kernel(*args), iters=iters) + cuda_ms(lambda: kernel(*args), iters=iters)) / 2
        return ms, (b0 + cuda_ms(lambda: baseline(*args), iters=iters)) / 2


def phase_timing(state, peak, main_err: dict, adj_err: dict, path_launches: dict, gen, baseline=None):
    fwd = {}
    for shape_name, (BT, H, W, C) in FORWARD_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            x, v, h = sepconv_operands(BT, H, W, C, KS, dtype, gen)
            bound, by = sepconv_bound_ms(x, v, h, peak)
            for name, (kernel, plain, _) in FORWARDS.items():
                ms, base_ms = timed_in_turns(kernel, (x, v, h), baseline and baseline[name])
                plain_ms = cuda_ms(lambda: plain(x, v, h), iters=2, warmup=1)
                fwd[name, shape_name, dtype] = (ms, plain_ms, bound, by, base_ms)
                emit("timing_kernel", kernel=name, dtype=str(dtype), shape=[BT, H, W, C, KS], ms=ms,
                     plain=plain.__name__, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                     achieved_over_bound=bound / ms, baseline_ms=base_ms)
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

    adj = time_adjoints(peak, gen, baseline)

    def launches(name):
        by_path = {p: n[name] for p, n in path_launches.items() if n[name]}
        return sum(by_path.values()), by_path

    kernels = []
    for name, (_, plain, line) in FORWARDS.items():
        ms16, plain16, bound16, by16, _ = fwd[name, "gray", torch.bfloat16]
        ms32, plain32, bound32, by32, _ = fwd[name, "gray", torch.float32]
        c16, cplain16, cbound16, _, _ = fwd[name, "color", torch.bfloat16]
        c32, cplain32, cbound32, _, _ = fwd[name, "color", torch.float32]
        t16, _, tbound16, _, _ = fwd[name, "gray_train", torch.bfloat16]
        ct16, ctplain16, ctbound16, _, _ = fwd[name, "color_train", torch.bfloat16]
        ct32, ctplain32, ctbound32, _, _ = fwd[name, "color_train", torch.float32]
        total, by_path = launches(name)
        baseline_keys = {} if baseline is None else {
            f"{prefix}baseline_ms{suffix}": fwd[name, shape_name, dtype][4]
            for prefix, shape_name in (("", "gray"), ("color_", "color"), ("train_", "gray_train"),
                                       ("color_train_", "color_train"))
            for suffix, dtype in (("", torch.bfloat16), ("_f32", torch.float32))}
        kernels.append({
            "name": name, "route": "cuda", "source": f"vfi_tpu_torch/ops/csrc/{name}.cu",
            "replaces": f"vfi_tpu/ops/sepconv.py:{line}", "launches": total, "launches_by_path": by_path,
            "max_abs_err": main_err[name], "ms": ms16, "plain_ms": plain16, "bound_ms": bound16, "bound_by": by16,
            "library_ms": None, "shape": [320, H, W, 1, KS], "dtype": "bfloat16", "plain": plain.__name__,
            "ms_f32": ms32, "plain_ms_f32": plain32, "bound_ms_f32": bound32, "bound_by_f32": by32,
            "color_shape": [80, 256, 320, 3, KS], "color_ms": c16, "color_plain_ms": cplain16,
            "color_bound_ms": cbound16, "color_ms_f32": c32, "color_plain_ms_f32": cplain32,
            "color_bound_ms_f32": cbound32, "train_shape": [40, H, W, 1, KS], "train_ms": t16,
            "train_bound_ms": tbound16, "color_train_shape": [20, 256, 320, 3, KS], "color_train_ms": ct16,
            "color_train_plain_ms": ctplain16, "color_train_bound_ms": ctbound16, "color_train_ms_f32": ct32,
            "color_train_plain_ms_f32": ctplain32, "color_train_bound_ms_f32": ctbound32, **baseline_keys,
        })
    for name, line in (("sepconv_bwd_vh", 608), ("sepconv_bwd_x", 729)):
        ms16, plain16, bound16, by16, base16 = adj[name, "gray_train", torch.bfloat16]
        ms32, plain32, bound32, by32, base32 = adj[name, "gray_train", torch.float32]
        c16, cplain16, cbound16, cby16, cbase16 = adj[name, "color_train", torch.bfloat16]
        c32, cplain32, cbound32, cby32, cbase32 = adj[name, "color_train", torch.float32]
        total, by_path = launches(name)
        baseline_keys = {} if base16 is None else {
            "baseline_ms": base16, "baseline_ms_f32": base32, "color_baseline_ms": cbase16,
            "color_baseline_ms_f32": cbase32}
        kernels.append({
            "name": name, "route": "cuda", "source": f"vfi_tpu_torch/ops/csrc/{name}.cu",
            "replaces": f"vfi_tpu/ops/sepconv.py:{line}", "launches": total, "launches_by_path": by_path,
            "max_abs_err": adj_err[name], "ms": ms16, "plain_ms": plain16, "bound_ms": bound16, "bound_by": by16,
            "library_ms": None, "shape": list(ADJOINT_SHAPES["gray_train"]) + [KS], "dtype": "bfloat16",
            "ms_f32": ms32, "plain_ms_f32": plain32, "bound_ms_f32": bound32, "bound_by_f32": by32,
            "color_shape": list(ADJOINT_SHAPES["color_train"]) + [KS], "color_ms": c16, "color_plain_ms": cplain16,
            "color_bound_ms": cbound16, "color_bound_by": cby16, "color_ms_f32": c32, "color_plain_ms_f32": cplain32,
            "color_bound_ms_f32": cbound32, "color_bound_by_f32": cby32, **baseline_keys,
        })
    print(json.dumps({"kernels": kernels}), flush=True)



def time_adjoints(peak, gen, baseline=None) -> dict:
    """CUDA-event times of both adjoint kernels and their plain versions at
    ``ADJOINT_SHAPES`` in bf16 and f32, with their bounds; emits a
    ``timing_kernel`` line each.  Returns {(name, shape, dtype): (ms,
    plain_ms, bound_ms, bound_by, baseline_ms)}.  ``baseline``
    (:func:`baseline_kernels`) is an earlier build of the same kernels, timed
    in turns with these (:func:`timed_in_turns`); baseline_ms is None without
    it."""
    adj = {}
    for shape_name, (BT, H, W, C) in ADJOINT_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            x, v, h, g = _adjoint_cases(BT, H, W, C, KS, dtype, gen)
            args = {"sepconv_bwd_vh": (x, v, h, g), "sepconv_bwd_x": (v, h, g)}
            runs = {
                "sepconv_bwd_vh": (sepconv_ops.sepconv_bwd_vh_cuda, sepconv_ops.sepconv_bwd_vh_plain,
                                   sepconv_bwd_vh_bound_ms(x, v, h, g, peak)),
                "sepconv_bwd_x": (sepconv_ops.sepconv_bwd_x_cuda, sepconv_ops.sepconv_bwd_x_plain,
                                  sepconv_bwd_x_bound_ms(v, h, g, peak)),
            }
            for name, (kernel, plain, (bound, by)) in runs.items():
                a = args[name]
                ms, base_ms = timed_in_turns(kernel, a, baseline and baseline[name])
                plain_ms = cuda_ms(lambda: plain(*a), iters=3, warmup=1)
                adj[name, shape_name, dtype] = (ms, plain_ms, bound, by, base_ms)
                emit("timing_kernel", kernel=name, dtype=str(dtype), shape=[BT, H, W, C, KS], ms=ms,
                     plain_ms=plain_ms, bound_ms=bound, bound_by=by, achieved_over_bound=bound / ms,
                     baseline_ms=base_ms)
            del x, v, h, g, args
            torch.cuda.empty_cache()
    return adj


def build_library(src: str, out_dir: str, entry: str, n_tensors: int):
    """nvcc ``src`` with the port's flags into ``out_dir`` (``lib<stem>.so``;
    its headers beside it) and bind its C entry ``entry`` (the port's entry
    signature: ``n_tensors`` pointers, their strides, B, H, W, C, ks, dtype,
    stream).  Returns (entry, ptxas lines)."""
    import ctypes

    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"lib{os.path.splitext(os.path.basename(src))[0]}.so")
    proc = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", lib, src], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise SystemExit(f"chip_smoke: {src} failed to build:\n{log}")
    fn = getattr(ctypes.CDLL(lib), entry)
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [P] * n_tensors + [I64] * (4 * n_tensors) + [I] * 6 + [P]
    fn.restype = I
    return fn, [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]


def build_variants(wanted: dict) -> dict:
    """Build variants of the port's kernels, every nvcc process at once.
    ``wanted`` maps (kernel, variant) to a list of (file, old, new): ``file``
    is the kernel's source (``"kernel"``) or one of ``_kernels.HEADERS``, in
    which every ``old`` is replaced by ``new``.  Each variant is written with
    the headers into its own ``vfi_tpu_torch/_build/variants/<kernel>-<variant>/``.
    Returns {(kernel, variant): (C entry, ptxas lines)}."""
    import shutil

    jobs = []
    for (kernel, name), patches in wanted.items():
        out_dir = _kernels.BUILD_DIR / "variants" / f"{kernel}-{name}"
        out_dir.mkdir(parents=True, exist_ok=True)
        src = _kernels.SOURCES[kernel]
        for f in (src, *_kernels.HEADERS):
            shutil.copy(_kernels.CSRC / f, out_dir / f)
        for f, old, new in patches:
            path = out_dir / (src if f == "kernel" else f)
            text = path.read_text()
            if old not in text:
                raise SystemExit(f"variant {kernel}/{name}: {old!r} is not in {path.name}")
            path.write_text(text.replace(old, new))
        jobs.append((str(out_dir / src), str(out_dir), kernel))
    with concurrent.futures.ThreadPoolExecutor(max(1, len(jobs))) as pool:
        built = list(pool.map(lambda j: build_library(j[0], j[1], j[2], _kernels._N_TENSORS[j[2]]), jobs))
    return dict(zip(wanted, built))


def call_library(fn, tensors, B, H, W, C, ks) -> None:
    rc = fn(*(t.data_ptr() for t in tensors), *(s for t in tensors for s in t.stride()), B, H, W, C, ks,
            _kernels._DTYPE_CODE[tensors[0].dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise SystemExit(f"chip_smoke: launch failed: CUDA error {rc}")


def baseline_kernels(checkout: str) -> dict:
    """The four kernels of another checkout of this repo (an earlier commit,
    whose C entries take the same arguments), built into
    ``vfi_tpu_torch/_build/baseline/`` and wrapped as the port's wrappers are."""
    csrc = os.path.join(checkout, "vfi_tpu_torch", "ops", "csrc")
    out_dir = os.path.join(str(_kernels.BUILD_DIR), "baseline")
    with concurrent.futures.ThreadPoolExecutor() as pool:  # every nvcc process at once
        built = dict(zip(KERNELS, pool.map(
            lambda k: build_library(os.path.join(csrc, f"{k}.cu"), out_dir, k, _kernels._N_TENSORS[k]), KERNELS)))
    emit("baseline_build", checkout=checkout, ptxas={k: log for k, (_, log) in built.items()})
    (fm, _), (fd, _), (vh, _), (bx, _) = (built[k] for k in KERNELS)

    def forward(fn):
        def run(x, v, h):
            out = torch.empty((*v.shape[:3], x.shape[-1]), dtype=x.dtype, device=x.device)
            call_library(fn, (x, v, h, out), *v.shape[:3], x.shape[-1], v.shape[-1])
            return out
        return run

    def bwd_vh(x, v, h, g):
        gv, gh = torch.empty_like(v), torch.empty_like(h)
        call_library(vh, (x, v, h, g, gv, gh), *v.shape[:3], x.shape[-1], v.shape[-1])
        return gv, gh

    def bwd_x(v, h, g):
        B, H, W, ks = v.shape
        gx = torch.empty((B, H + ks - 1, W + ks - 1, g.shape[-1]), dtype=g.dtype, device=g.device)
        call_library(bx, (v, h, g, gx), B, H, W, g.shape[-1], ks)
        return gx

    return {"sepconv_fwd_mxu": forward(fm), "sepconv_fwd": forward(fd), "sepconv_bwd_vh": bwd_vh,
            "sepconv_bwd_x": bwd_x}


def _serve_timing(ip, key, impl, dtype, B, T, H, W, C, gen) -> None:
    p = torch.rand(B, 5, H, W, C, device="cuda", generator=gen).to(dtype) * 2 - 1
    f = torch.rand(B, 5, H, W, C, device="cuda", generator=gen).to(dtype) * 2 - 1
    torch.cuda.reset_peak_memory_stats()
    with uncounted():
        ms = cuda_ms(lambda: ip.forward(T, p, f), iters=5)
    emit("timing_serve", model=key, sepconv_impl=impl, dtype=str(dtype), batch=B, T=T, shape=[H, W, C], tf32=False,
         ms_per_batch=ms, middle_frames_per_s=B * T / (ms / 1e3),
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated())


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.")
    ap.add_argument("--baseline", metavar="CHECKOUT",
                    help="another checkout of this repo (an earlier commit): time its four kernels in turns "
                         "with these, as baseline_* keys of the timing_kernel and kernels lines")
    args = ap.parse_args(argv)
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
    spills = {n: [ln for ln in lines if re.search(r"[1-9]\d* bytes spill (stores|loads)", ln)]
              for n, lines in ptxas.items()}
    gate(not any(spills.values()), f"ptxas reports spills: {spills}")
    baseline = baseline_kernels(os.path.abspath(args.baseline)) if args.baseline else None

    gen = torch.Generator(device="cuda").manual_seed(0)
    main_err = phase_kernel_checks(gen)
    adj_err = phase_adjoint_checks(gen)
    state = params_from_jax(random_jax_params(GOLDEN["model_key"], GOLDEN["param_seed"]))
    paths = {"serve": phase_serve(state), "serve_pallas": phase_serve(state, "pallas"),
             "serve_color": phase_serve_color()}
    predict_root = os.path.join(str(_kernels.BUILD_DIR), "predict_smoke")
    shutil.rmtree(predict_root, ignore_errors=True)
    try:
        predict_paths, (videolist, warm) = phase_predict(predict_root)
        paths.update(predict_paths)
        phase_timing_predict(predict_root, videolist, warm)
    finally:
        shutil.rmtree(predict_root, ignore_errors=True)
    torch.cuda.empty_cache()
    env, tstate, targets = phase_train_golden()
    phase_train_kernel_vs_plain(env, tstate, targets)
    del env, tstate, targets
    torch.cuda.empty_cache()
    paths["train_pallas"] = phase_train_pallas()
    torch.cuda.empty_cache()
    paths["train"], train_ms = phase_train(gen)
    paths["train_color"] = phase_train_color(gen)
    train_cli_root = os.path.join(str(_kernels.BUILD_DIR), "train_cli_smoke")
    shutil.rmtree(train_cli_root, ignore_errors=True)
    try:
        lists = _train_cli_lists(train_cli_root)
        paths.update(phase_train_cli(train_cli_root, lists))
        phase_timing_train_cli(train_cli_root, lists, train_ms)
    finally:
        shutil.rmtree(train_cli_root, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_timing(state, peak, main_err, adj_err, paths, gen, baseline)

    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

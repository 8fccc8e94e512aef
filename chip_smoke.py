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
``"pallas"``.  Then the rest of the model zoo through the same entry points:
Super SloMo at UCF-101's configuration and the SCT family at KTH's.
Phases, one JSON line each:

  1. device      — the card's name and count; fails without CUDA.
  2. build       — compiles every CUDA kernel from ``vfi_tpu_torch/ops/csrc``
                   (five sources), all nvcc processes at once; fails if ptxas
                   reports a spill in any instantiation, or if the int8 conv's
                   SASS (``cuobjdump -sass``) holds no IGMMA (wgmma s8).
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
  6a. qconv_kernel — the int8 serving kernel (``ops/csrc/qconv_int8.cu``,
                   the activation quantize fused into a wgmma int8 conv)
                   against ``qconv_int8_plain(quantize_int8_plain(x))`` at
                   every conv shape of TAI_gray's int8 forward (36) and
                   SloMo_color's 7x7 and 1x1 convs (5), on 2 images of
                   float32 and of bfloat16 x: the int32 sums exact, the
                   dequantized outputs within one float32 / bfloat16 ulp, the
                   quantized bytes equal (a centre-tap identity conv returns
                   them), the element path (strided x) exact; then each
                   TAI_gray shape timed at its images per call at B=64 beside
                   its bound, cuDNN's bf16 conv and ``torch._int_mm`` on the
                   GEMM's operands (with ``--baseline``, that checkout's
                   quantize + conv in turns).
  6b. serve_int8 — TAI_gray under VFI_INT8 (f32, TF32 off) against
                   ``tests/torch_golden_tai_gray_int8.npz``: static with the
                   golden's scales, static with the port's own calibration,
                   dynamic; 180 int8 conv launches and 2 banded ones per
                   forward; every int8 conv call within one ulp of its plain
                   recomputation; pred at uint8 PSNR >= 45 dB against vfi_tpu's
                   int8 pred and no more than 0.5 dB further from the float32
                   golden than vfi_tpu's.  bf16 timings beside the float forward
                   (B=64 static and dynamic, B=8 static), TAI_color 256x320
                   static at B=16.
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
  7a. predict_int8 — the same CLI with ``--quantize int8`` (bf16
                   ``--device_normalize`` B=64, calibration on 8 clips, the
                   validate_quant gate on 4) and ``--quantize int8_dynamic``
                   (16 clips, B=16): the calibration and gate lines, every PNG,
                   and the launches of calibration, gate and loop.
  7b. reference_import — the reproduction path: a seeded
                   ``tests/torch_mirror.py`` TAI_gray at full width (the
                   reference's state_dict layout) saved as a reference
                   snapshot, through ``cli.import_torch_checkpoint``: every
                   tensor converted, ``merge_residual1``'s four skipped; its f32
                   forward by ``VideoInpainter.from_checkpoint`` against the
                   mirror's own forward on the card (B=2, K=T=F=5, TF32 off):
                   max-abs <= 5e-3 and uint8 PSNR >= 45 dB on every output, 2
                   banded launches and no call of a plain sepconv; then
                   ``cli.predict`` from the imported snapshot in bf16 on 16
                   of ``predict``'s clips (B=8, 4 banded launches),
                   ``cli.compute_quant_results`` on the card, and
                   ``cli.summarize_quant_results``' two text tables equal to
                   numpy's means, standard errors and per-video means of the
                   same results.npz; then ``OFFillInModel``: the ImportError
                   naming OpenCV or scipy where either is missing, else two
                   clips served by the predict CLI; the outcome and the
                   seconds of each step printed.
  7c. figures    — the figure and animation tools (``eval/animate``,
                   ``eval/figures``, ``eval/records`` and their six CLIs) fed
                   by ``cli.predict`` on ``predict``'s snapshot and first 4
                   clips, bf16 ``--intermediate_preds`` at B=4, under two
                   experiment names (``--quantize none`` and ``int8``): 2
                   banded launches per forward, 180 int8 conv launches per
                   int8 forward, no plain sepconv or int8 call, every
                   intermediate PNG; ``cli.compute_quant_results`` on the
                   card; then animate_qual_results ``--create_gt_gif`` (a
                   pool of 2), generate_comparison_videos,
                   compare_visual_results (gif, mp4, images-uncomp; the PDF
                   grid), compare_intermediate_preds (both subcommands),
                   paper_figures (register, images, plot) and the unified
                   boxplot: each output's frame count and size from K, T, F
                   and the layout, the image strip pixel for pixel against
                   its source PNGs; a tool whose package (imageio, OpenCV,
                   matplotlib) is missing must raise the ImportError naming
                   it.  Prints the host packages found and each step's
                   seconds.
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
                   ``--device_normalize`` ``--sample_KTF`` B=8, 20 iterations
                   (snapshots every 10, validation every 15), then a resume
                   to 30; 30 finite ``iter`` events, resumes at 0 and 20, 6
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
                   a fresh init, 10 warm-up and 30 timed iterations at
                   ``--print_freq 10``, at fixed K=T=F=5 and under
                   ``--sample_KTF``: ms/it (median of the print windows after
                   the first) beside ``train``'s ms per step, the host's
                   seconds (prefetcher, copy and normalise, step dispatch,
                   sync at print), one validation sweep and one snapshot
                   save (at fixed K, T, F).
 14a. ddp_train — data parallelism: the train CLI launched by torchrun as
                   rank processes of this script (``--rank_worker``; the card's
                   compute mode printed first).  One rank over NCCL (f32 B=2,
                   3 iterations in order) against the run without a launch:
                   terms within rel 1e-6.  Two ranks over gloo sharing cuda:0:
                   f32 at local B=1 in order against the one-process B=2 run
                   (rel 1e-3, iterations 1-3); bf16 ``--device_normalize
                   --sample_KTF`` at local B=4, 20 iterations (snapshots and
                   validation every 10, on 15 clips: shards of 8 and 7) and a
                   resume to 30: finite terms, the same (K, T, F) on both
                   ranks, final states bit-identical (sha256), snapshots and
                   TensorBoard files from rank 0 alone, 15 gathered rows per
                   sweep, both ranks resuming at 20, each rank's launches
                   from its own schedule; ms/it per rank and the bytes of
                   each gradient all-reduce.
 14b. ddp_predict — the predict CLI as two ranks sharing cuda:0, in the same
                   launch, on ``predict``'s snapshot and clips: bf16 B=64 on
                   130 clips (65 a rank, one padded batch each) writes the
                   one-process tree; f32 on 16 clips at B=8 within 1 uint8
                   level of the one-process PNGs; ``--quantize int8`` on 16
                   clips: the same scales (sha256) and gate verdict on both
                   ranks, pred_middle at uint8 PSNR >= 45 dB of the
                   one-process int8 run; launches per rank.
 15-22. the model zoo (Super SloMo, SCT), none of which runs sepconv: each
                   path gates 0 launches of every sepconv kernel, and of the
                   int8 kernel but in ``zoo_int8``; ``zoo`` prints the
                   phases' wall seconds.
     slomo_golden — SloMoFillInModel_color at 256x320, B=2, T=5, f32, in both
                   warp modes, against ``tests/torch_golden_slomo_color.npz``:
                   max-abs <= 5e-3 at 4096 points of each output, uint8 PSNR
                   >= 45 dB at 131072 points of pred.
     slomo_predict — SloMo served by ``cli.predict`` at UCF-101's test
                   argfiles (K=4, T=5, F=4, 240x320 padded to 256x320, B=16)
                   from a port snapshot, 16 synthetic 13-frame clips, bf16
                   ``--device_normalize``, twice: every PNG written at
                   240x320, finite metrics from ``compute_quant_results``,
                   middle frames/s of the loop and of the forward.
     slomo_train_cli — SloMo through ``cli.train`` at UCF-101's train
                   argfiles (160x192, ``--sample_KTF``) with a seeded VGG16
                   .npz, bf16 B=8: 20 iterations, a resume to 30, the
                   events, and every update's rate the schedule's
                   (``--lr_decay_count 15``); then f32 B=2 against
                   ``SloMoEnvironment.train_step`` (rel 1e-3).
     slomo_train_golden — two f32 SloMo steps (B=1, 160x192, T=3) against
                   ``tests/torch_golden_train_slomo.npz``: terms rel 1e-3,
                   gradient projections global-L2-relative 1e-3.
     sct_golden  — SCT Forward, Inward, Bypass, FrameEncDecBN (``_gray``,
                   d_v=256) and Forward's teacher-forced pass at 128x128,
                   K=T=F=5, f32, against ``tests/torch_golden_sct_gray.npz``
                   (the forward gates); RandomB bf16 B=8: finite, the same
                   seed bit-identical.
     sct_train_cli — SCT Forward through ``cli.train`` at the KTH train
                   argfile, teacher forcing falling from 0.99 to 0.007, bf16
                   B=8 from a port snapshot: 20 iterations and a resume to
                   30, both branches in the events; then f32 B=2 against
                   ``SCTEnvironment.train_step``.
     zoo_int8    — SloMo_color (256x320, K=F=4, T=5) and SCT Forward
                   (128x128, K=T=F=5) served by ``cli.predict`` from seeded
                   full-width weights, bf16 B=4 on 4 clips, under
                   ``--quantize int8`` and ``int8_dynamic`` with the
                   ``--validate_quant`` gate: every int8 conv call of
                   calibration, gate and loop equal to its plain
                   recomputation (0 ulps), one launch per call, no plain
                   call; then int8 static and dynamic timed in turns with
                   the float bf16 forward (SloMo B=16, SCT B=8).
     timing_zoo  — ms per batch serving SloMo (bf16 B=16, f32 B=2) and SCT
                   Forward and RandomB (bf16 B=8), ms per bf16 training step
                   of SloMo (B=8, 160x192) and SCT Forward (B=8).
 23. timing      — CUDA-event times of each kernel, its plain version and the
                   serving forwards (the forwards at both serving and both
                   training shapes, the adjoints at both training shapes;
                   with ``--baseline``, another checkout's four kernels in
                   turns with these); a ``kernels`` line with each kernel's
                   numbers, the int8 kernel's from ``qconv_kernel``.

Prints the card's name and power limit (nvidia-smi) on the line before the
last, and as the last line ``{"ok": true, "device": {...}}``.  Any failed gate
exits non-zero before that line.  Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import hashlib
import importlib.util
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
from tests import torch_mirror
from vfi_tpu_torch.cli import compute_quant_results as quant_cli
from vfi_tpu_torch.cli import import_torch_checkpoint as import_cli
from vfi_tpu_torch.cli import predict as predict_cli
from vfi_tpu_torch.cli import summarize_quant_results as summarize_cli
from vfi_tpu_torch.cli import train as train_cli
from vfi_tpu_torch.data import native_loader
from vfi_tpu_torch.data.datasets import ContiguousVideoClipDataset, batch_iterator
from vfi_tpu_torch.data.synthetic import make_videolist
from vfi_tpu_torch.models.registry import create_model, model_config
from vfi_tpu_torch.nn import quant
from vfi_tpu_torch.nn.layers import Conv
from vfi_tpu_torch.nn.vgg import random_vgg16_npz
from vfi_tpu_torch.ops import _kernels
from vfi_tpu_torch.ops import qconv as qconv_ops
from vfi_tpu_torch.ops import sepconv as sepconv_ops
from vfi_tpu_torch.train.environments import L2GDLDiscEnvironment, create_training_environment
from vfi_tpu_torch.utils import checkpoint as ckpt
from vfi_tpu_torch.utils.config import TrainConfig
from vfi_tpu_torch.utils.png import read_png, write_png
from vfi_tpu_torch.utils.params import (disc_variables_from_jax, params_from_jax, quant_from_jax,
                                        random_jax_disc_variables, random_jax_params)

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
# The int8 serving kernels (csrc/qconv_int8.cu), counted in ops/qconv.py.
QKERNELS = ("qconv_int8",)
COUNTED = {**{k: sepconv_ops for k in KERNELS}, **{k: qconv_ops for k in QKERNELS}}
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


# The model zoo's goldens (tests/make_torch_{slomo,sct,train_slomo}_golden.py):
# vfi_tpu on the CPU in f32.  Each output's float values are kept at n_points
# positions and pred's uint8 values at n_u8_points (all of pred where that is
# its size), the positions drawn from point_seed by sampled_points.
SLOMO_GOLDEN_PATH = os.path.join(REPO, "tests", "torch_golden_slomo_color.npz")
SLOMO_GOLDEN = dict(model_key="SloMoFillInModel_color", param_seed=0, input_seed=8, B=2, K=4, F=4, T=5, H=256,
                    W=320, C=3, n_points=4096, n_u8_points=131072, point_seed=9)
SLOMO_KEYS = ("pred", "F_0_1", "F_1_0", "F_t_0_collector", "F_t_1_collector")
WARP_MODES = ("pixel", "torch03")
SCT_GOLDEN_PATH = os.path.join(REPO, "tests", "torch_golden_sct_gray.npz")
SCT_GOLDEN = dict(param_seed=0, input_seed=10, B=1, K=5, F=5, T=5, H=128, W=128, C=1, n_points=4096,
                  n_u8_points=81920, point_seed=11)
# The deterministic SCT variants at full width; "forward_train" is Forward's teacher-forced pass.
SCT_GOLDEN_RUNS = {"forward": "SCTSkipConScaledTForward_gray", "forward_train": "SCTSkipConScaledTForward_gray",
                   "inward": "SCTSkipConScaledTInward_gray", "bypass": "SCTBypassScaledTForward_gray",
                   "frame_enc_dec_bn": "SCTFrameEncDecBNSkipConScaledTForward_gray"}
SLOMO_TRAIN_GOLDEN_PATH = os.path.join(REPO, "tests", "torch_golden_train_slomo.npz")
# SloMoEnvironment at TrainConfig's defaults with a VGG16 .npz drawn from vgg_seed.
SLOMO_TRAIN_GOLDEN = dict(model_key="SloMoFillInModel_color", param_seed=0, input_seed=12, proj_seed=13, vgg_seed=14,
                          B=1, K=4, T=3, F=4, H=160, W=192, C=3, steps=2)
SLOMO_TERM_NAMES = ("reconstruction_loss", "perceptual_loss", "warping_loss", "smooth_loss", "G_loss")


def sampled_points(size: int, n: int, seed: int) -> np.ndarray:
    """``n`` distinct flat indices into an array of ``size`` elements (all of them, in order, when n >= size)."""
    if n >= size:
        return np.arange(size, dtype=np.int64)
    return np.sort(np.random.RandomState(seed).choice(size, n, replace=False))


def sampled_golden(out: dict, cfg: dict, prefix: str, keys) -> dict:
    """The arrays a golden keeps of a forward's outputs (numpy, channels-last):
    ``{prefix}{key}_at_points`` for every key, ``{prefix}pred_u8_at_points``."""
    arrays = {}
    for i, key in enumerate(keys):
        a = np.asarray(out[key], np.float32).reshape(-1)
        arrays[f"{prefix}{key}_at_points"] = a[sampled_points(a.size, cfg["n_points"], cfg["point_seed"] + i)]
    pred = np.asarray(out["pred"], np.float32).reshape(-1)
    arrays[f"{prefix}pred_u8_at_points"] = u8(pred[sampled_points(pred.size, cfg["n_u8_points"], cfg["point_seed"])])
    return arrays


def check_sampled_golden(out: dict, golden, cfg: dict, prefix: str, keys) -> dict:
    """A forward's outputs against a golden kept by :func:`sampled_golden`:
    each output's max-abs at its points, pred's uint8 PSNR at its points."""
    got = sampled_golden({k: out[k].float().cpu().numpy() for k in keys}, cfg, prefix, keys)
    res = {f"{key}_max_abs": float(np.abs(got[f"{prefix}{key}_at_points"] - golden[f"{prefix}{key}_at_points"]).max())
           for key in keys}
    res["pred_u8_psnr_db"] = u8_psnr(got[f"{prefix}pred_u8_at_points"], golden[f"{prefix}pred_u8_at_points"])
    res["ok"] = bool(max(res[f"{k}_max_abs"] for k in keys) <= 5e-3 and res["pred_u8_psnr_db"] >= 45.0)
    return res


def _meta_ok(golden, cfg: dict) -> bool:
    return all(str(golden[k]) == str(v) for k, v in cfg.items())


def check_slomo_golden(device) -> dict:
    """SloMoFillInModel_color in f32 in both warp modes against the SloMo golden: {mode: report}."""
    cfg = SLOMO_GOLDEN
    golden = np.load(SLOMO_GOLDEN_PATH)
    state = params_from_jax(random_jax_params(cfg["model_key"], cfg["param_seed"]))
    p, f = (torch.from_numpy(a).to(device) for a in golden_inputs(cfg))
    reports = {}
    for mode in WARP_MODES:
        spec = copy.deepcopy(model_config(cfg["model_key"]))
        spec["kwargs"]["warp_mode"] = mode
        model = create_model(spec)
        model.load_state_dict(state)
        model.to(device).eval()
        with torch.inference_mode():
            out = model(cfg["T"], p, f)
        reports[mode] = {"meta_ok": _meta_ok(golden, cfg), **check_sampled_golden(out, golden, cfg, f"{mode}/",
                                                                                  SLOMO_KEYS)}
        reports[mode]["ok"] &= reports[mode]["meta_ok"]
        del model, out
    return reports


def sct_golden_inputs(cfg=SCT_GOLDEN):
    """The SCT golden's preceding, middle and following frames, [B, K|T|F, H, W, C] in [-1, 1]."""
    rng = np.random.RandomState(cfg["input_seed"])
    return tuple(rng.uniform(-1, 1, (cfg["B"], n, cfg["H"], cfg["W"], cfg["C"])).astype(np.float32)
                 for n in (cfg["K"], cfg["T"], cfg["F"]))


def check_sct_golden(device) -> dict:
    """The deterministic SCT variants (and Forward's teacher-forced pass) in
    f32 against the SCT golden: {run: report}."""
    cfg = SCT_GOLDEN
    golden = np.load(SCT_GOLDEN_PATH)
    p, m, f = (torch.from_numpy(a).to(device) for a in sct_golden_inputs(cfg))
    reports = {}
    for run, key in SCT_GOLDEN_RUNS.items():
        model = create_model(key)
        model.load_state_dict(params_from_jax(random_jax_params(key, cfg["param_seed"])))
        model.to(device).eval()
        with torch.inference_mode():
            out = model(cfg["T"], p, f, gt_middle=m) if run == "forward_train" else model(cfg["T"], p, f)
        reports[run] = {"meta_ok": _meta_ok(golden, cfg), **check_sampled_golden(out, golden, cfg, f"{run}/",
                                                                                 ("pred",))}
        reports[run]["ok"] &= reports[run]["meta_ok"]
        del model, out
    return reports


def slomo_train_golden_setup(vgg_path: str, cfg=SLOMO_TRAIN_GOLDEN):
    """The SloMo training golden's inputs: (TrainConfig, flax G params,
    targets [B, K+T+F, H, W, C], r_g), with the VGG16 weights of
    ``random_vgg16_npz(vgg_path, vgg_seed)``; r_g as ``train_golden_setup``
    draws it."""
    random_vgg16_npz(vgg_path, cfg["vgg_seed"])
    train_cfg = TrainConfig(K=cfg["K"], T=cfg["T"], F=cfg["F"], vgg16_weights=vgg_path)
    g_params = random_jax_params(cfg["model_key"], cfg["param_seed"])
    shape = (cfg["B"], cfg["K"] + cfg["T"] + cfg["F"], cfg["H"], cfg["W"], cfg["C"])
    targets = np.random.RandomState(cfg["input_seed"]).uniform(-1, 1, shape).astype(np.float32)
    r_g = params_from_jax(_random_like(g_params, np.random.RandomState(cfg["proj_seed"])))
    return train_cfg, g_params, targets, r_g


def check_slomo_train_golden(device, vgg_path: str, cfg=SLOMO_TRAIN_GOLDEN) -> dict:
    """The port's two f32 SloMoEnvironment steps on ``device`` against the
    SloMo training golden: loss terms (rel 1e-3) and step-1 gradient
    projections (global-L2-relative 1e-3)."""
    golden = np.load(SLOMO_TRAIN_GOLDEN_PATH)
    train_cfg, g_params, targets, r_g = slomo_train_golden_setup(vgg_path, cfg)
    env = create_training_environment(create_model(cfg["model_key"]), train_cfg)
    state = env.init_state((cfg["H"], cfg["W"]), g_params=g_params, device=device)
    terms = []
    for step in range(cfg["steps"]):
        state, m = env.train_step(state, cfg["K"], cfg["T"], cfg["F"], targets)
        terms.append([float(m[n]) for n in golden["term_names"]])
        if step == 0:
            g_proj = grad_projections({n: p.grad for n, p in state.generator.named_parameters()}, r_g)
    terms_rel = np.abs(np.array(terms) - golden["terms"]) / np.maximum(np.abs(golden["terms"]), 1e-12)
    report = dict(meta_ok=_meta_ok(golden, cfg), terms_max_rel=float(terms_rel.max()),
                  worst_term=str(golden["term_names"][terms_rel.max(axis=0).argmax()]),
                  g_proj_rel=_global_rel(g_proj, golden["g_proj"]), terms=terms)
    report["ok"] = bool(report["meta_ok"] and report["terms_max_rel"] <= 1e-3 and report["g_proj_rel"] <= 1e-3)
    return report


T_START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw, "t_s": time.perf_counter() - T_START}), flush=True)


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
    return {k: getattr(module, f"{k}_launches") for k, module in COUNTED.items()}


def _reset_launch_counts() -> None:
    for k, module in COUNTED.items():
        setattr(module, f"{k}_launches", 0)


def _gate_launches(path: str, launches: dict, want: dict) -> None:
    for k in COUNTED:
        gate(launches[k] == want.get(k, 0), f"{path}: {k} launched {launches[k]} times, want {want.get(k, 0)}")


@contextlib.contextmanager
def uncounted():
    """Launches inside (timings of a kernel alone) leave the counts as they were."""
    saved = _launch_counts()
    try:
        yield
    finally:
        for k, n in saved.items():
            setattr(COUNTED[k], f"{k}_launches", n)


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


# The int8 serving phases: vfi_tpu's VFI_INT8 / --quantize modes through the
# port's int8 kernel (ops/csrc/qconv_int8.cu).
INT8_GOLDEN_PATH = os.path.join(REPO, "tests", "torch_golden_tai_gray_int8.npz")
# SloMo_color's 7x7 first convs and 1x1 out convs (C_in, C_out, k, H, W), checked beside TAI_gray's.
SLOMO_QCONV_SHAPES = ((6, 32, 7, 256, 320), (16, 32, 7, 256, 320), (32, 32, 7, 256, 320), (32, 4, 1, 256, 320),
                      (32, 5, 1, 256, 320))
# The conv timed in the kernels line: TAI_gray's most frequent int8 conv
# (MC-Net's 3x3 256->256 convs at 32x32, 25 calls per forward), at B=64.
QCONV_HEADLINE = (256, 256, 3, 32, 32, 128)
INT8_SERVE_B = 64


@contextlib.contextmanager
def vfi_int8(mode: str):
    """VFI_INT8 set to ``mode`` inside (create_model reads it), as it was after."""
    saved = os.environ.get("VFI_INT8")
    os.environ["VFI_INT8"] = mode
    try:
        yield
    finally:
        os.environ.pop("VFI_INT8")
        if saved is not None:
            os.environ["VFI_INT8"] = saved


def int8_inpainter(model, state, mode: str, dtype) -> VideoInpainter:
    with vfi_int8(mode):
        return VideoInpainter(model, state, device="cuda", dtype=dtype)


def int8_calls(model, T, p, f) -> tuple[dict, list]:
    """One forward of ``model`` with every QConv call recorded: (outputs,
    [(path, C_in, C_out, k, H, W, images)]), the run's own schedule."""
    calls = []
    hooks = [m.register_forward_pre_hook(lambda m, inp, n=n: calls.append(
        (n, inp[0].shape[1], m.out_channels, m.kernel_size[0], inp[0].shape[2], inp[0].shape[3], inp[0].shape[0])))
        for n, m in quant.qconvs(model).items()]
    try:
        with torch.inference_mode():
            out = model(T, p, f)
    finally:
        for h in hooks:
            h.remove()
    return out, calls


def int8_schedule(state) -> list:
    """TAI_gray's int8 conv calls in one forward on the golden inputs (dynamic
    mode, uncounted): [(path, C_in, C_out, k, H, W, images)]."""
    ip = int8_inpainter(GOLDEN["model_key"], state, "1", torch.float32)
    p, f = (torch.from_numpy(a).cuda() for a in golden_inputs())
    with uncounted():
        _, calls = int8_calls(ip.model, GOLDEN["T"], p, f)
    return calls


def int8_peak(peak) -> float:
    """Dense int8 tensor-core rate: twice the dense bf16 rate on these cards (data sheets)."""
    return 2 * peak[1]


def qconv_bound_ms(images, cin, cout, k, h, w, in_bytes, out_bytes, peak) -> tuple[float, str]:
    """The fused kernel: x (its own dtype, the unpadded channels), the int8
    weights and the output once over the memory rate; or 2 * MAC (the
    unpadded channels) over the dense int8 rate."""
    cp = qconv_ops.padded_channels(cin)
    nbytes = images * cin * h * w * in_bytes + cout * k * k * cp + images * cout * h * w * out_bytes
    t_bytes = nbytes / peak[0] * 1e3
    t_ops = 2 * images * h * w * cout * cin * k * k / int8_peak(peak) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def unfused_bound_ms(images, cin, cout, k, h, w, in_bytes, out_bytes, peak) -> float:
    """The bound of a separate quantize pass (x read, NHWC int8 written) plus
    an int8 conv that reads it back, as an unfused quantize kernel and conv run."""
    cp = qconv_ops.padded_channels(cin)
    quantize = (images * cin * h * w * in_bytes + images * h * w * cp) / peak[0] * 1e3
    conv_bytes = (images * h * w * cp + cout * k * k * cp + images * cout * h * w * out_bytes) / peak[0] * 1e3
    return quantize + max(conv_bytes, 2 * images * h * w * cout * cin * k * k / int8_peak(peak) * 1e3)


def int_mm_ms(images, cin, cout, k, h, w, gen):
    """The yardstick, never on the port's path: one ``torch._int_mm`` on random
    int8 operands of the implicit GEMM's [N*H*W, k*k*Cp] x [k*k*Cp, Co] (Co
    padded to a multiple of 8): the GEMM alone, im2col not counted.  None
    where the call refuses the shape."""
    m, kk, n = images * h * w, k * k * qconv_ops.padded_channels(cin), -(-cout // 8) * 8
    a = torch.randint(-127, 128, (m, kk), dtype=torch.int8, device="cuda", generator=gen)
    b = torch.randint(-127, 128, (n, kk), dtype=torch.int8, device="cuda", generator=gen).t()
    try:
        return cuda_ms(lambda: torch._int_mm(a, b), iters=5)
    except RuntimeError as e:
        emit("int_mm_refused", shape=[m, kk, n], error=str(e)[:200])
        return None


def f32_ulp(t: torch.Tensor) -> torch.Tensor:
    a = t.abs()
    return torch.nextafter(a, torch.full_like(a, math.inf)) - a


def _qconv_operands(images, cin, cout, k, h, w, gen):
    """x ~ 2 N(0, 1) in float32, its dynamic scale, a QConv's int8 weights
    (He-normal float weights through ``QConv.quantized_weight``) and a bias."""
    x = torch.randn(images, cin, h, w, device="cuda", generator=gen) * 2
    x_scale = torch.clamp_min(x.abs().amax() * quant.INV_127, quant.EPS)
    conv = torch.nn.Sequential(Conv(cin, cout, k)).cuda()
    with torch.no_grad():
        conv[0].weight.copy_(torch.randn(conv[0].weight.shape, device="cuda", generator=gen)
                             * math.sqrt(2.0 / (cin * k * k)))
        conv[0].bias.copy_(torch.randn(cout, device="cuda", generator=gen) * 0.1)
    quant.quantize_convs(conv, static=False)
    wq, w_scale = conv[0].quantized_weight()
    return x, x_scale, wq, (x_scale * w_scale).contiguous(), conv[0].bias.detach(), conv[0].weight.detach()


def phase_qconv_kernel(gen, peak, schedule, baseline=None) -> dict:
    """The fused int8 kernel against ``qconv_int8_plain(quantize_int8_plain(x))``
    at every conv shape of TAI_gray's int8 forward (``schedule``) and
    SloMo_color's 7x7 and 1x1 convs, on 2 images, float32 and bfloat16 x:
    the int32 sums exact, float32 and bfloat16 outputs within one ulp of the
    plain epilogue, and the quantized bytes equal to ``quantize_int8_plain``'s
    (a centre-tap identity conv returns them as its int32 sums); and the
    element path (x with non-unit column stride) exact.  Then each TAI_gray
    (shape, images per call at B=64), where a block runs many work items,
    held to the same gates on bfloat16 x (int32 exact, bfloat16 output within
    one ulp; the headline's float32 output too) and timed (bf16 in and out)
    beside its bound,
    cuDNN's bf16 conv, ``torch._int_mm`` on the GEMM's operands and, with
    ``baseline``, that checkout's quantize + conv in turns.  Returns the
    kernels line's numbers."""
    t0 = time.perf_counter()
    shapes = sorted({c[1:6] for c in schedule})
    worst = {"qconv_int8_int32": 0, "qconv_int8_f32_ulps": 0.0, "qconv_int8_bf16_ulps": 0.0,
             "element_path_int32": 0}
    with uncounted():
        for cin, cout, k, h, w in shapes + list(SLOMO_QCONV_SHAPES):
            x, s, wq, scale, b, _ = _qconv_operands(2, cin, cout, k, h, w, gen)
            packed = qconv_ops.pack_weight(wq, qconv_ops.n_tile(cout))
            cp = qconv_ops.padded_channels(cin)
            eye = torch.zeros(cp, k, k, cp, dtype=torch.int8, device="cuda")
            eye[torch.arange(cp), k // 2, k // 2, torch.arange(cp)] = 1
            eye_packed = qconv_ops.pack_weight(eye, qconv_ops.n_tile(cp))
            for xin in (x, x.bfloat16()):
                xq = qconv_ops.quantize_int8_plain(xin, s)
                acc_p = qconv_ops.qconv_int8_plain(xq, wq)
                acc = qconv_ops.qconv_int8_cuda(xin, s, wq, packed)
                y32 = qconv_ops.qconv_int8_cuda(xin, s, wq, packed, scale, b, torch.float32)
                y16 = qconv_ops.qconv_int8_cuda(xin, s, wq, packed, scale, b, torch.bfloat16)
                ident = qconv_ops.qconv_int8_cuda(xin, s, eye, eye_packed)
                torch.cuda.synchronize()
                want32 = qconv_ops.dequantize_plain(acc_p, scale, b, torch.float32)
                want16 = qconv_ops.dequantize_plain(acc_p, scale, b, torch.bfloat16)
                d_int = int((acc.long() - acc_p.long()).abs().max())
                ulps32 = float(((y32 - want32).abs() / f32_ulp(want32)).max())
                ulps16 = float(((y16.float() - want16.float()).abs() / bf16_ulp(want16.float())).max())
                worst["qconv_int8_int32"] = max(worst["qconv_int8_int32"], d_int)
                worst["qconv_int8_f32_ulps"] = max(worst["qconv_int8_f32_ulps"], ulps32)
                worst["qconv_int8_bf16_ulps"] = max(worst["qconv_int8_bf16_ulps"], ulps16)
                what = f"qconv_int8 {cin, cout, k, h, w} {xin.dtype} x"
                gate(torch.equal(ident, xq.permute(0, 3, 1, 2).int()),
                     f"{what}: quantized bytes differ from quantize_int8_plain's")
                gate(d_int == 0, f"{what}: int32 sums off the plain conv by {d_int}")
                gate(ulps32 <= 1.0, f"{what}: float32 output {ulps32} ulps off the plain epilogue")
                gate(ulps16 <= 1.0, f"{what}: bfloat16 output {ulps16} ulps off")
                del xq, acc, y32, y16, ident, want32, want16
            # The element path: the same bfloat16 values, columns not contiguous.
            xs = x.bfloat16().transpose(2, 3).contiguous().transpose(2, 3)
            d_el = int((qconv_ops.qconv_int8_cuda(xs, s, wq, packed).long() - acc_p.long()).abs().max())
            worst["element_path_int32"] = max(worst["element_path_int32"], d_el)
            gate(d_el == 0, f"qconv_int8 {cin, cout, k, h, w}: element path's int32 sums off by {d_el}")
            del x, xs, eye, eye_packed, packed, acc_p
        emit("qconv_kernel_checks", tai_gray_shapes=len(shapes), slomo_shapes=len(SLOMO_QCONV_SHAPES), images=2,
             inputs=["float32", "bfloat16"], quantized_bytes_equal=True, **worst)
        torch.cuda.empty_cache()

        counts = {}
        for _, cin, cout, k, h, w, n in schedule:
            key = (cin, cout, k, h, w, n * INT8_SERVE_B)
            counts[key] = counts.get(key, 0) + 1
        totals = {"ms": 0.0, "bound_ms": 0.0, "cudnn_bf16_ms": 0.0, "library_ms": 0.0}
        base_fn = (baseline or {}).get("qconv_int8")
        if base_fn is not None:
            totals.update(baseline_ms=0.0, baseline_bound_ms=0.0)
        headline = None
        at_batch = {"qconv_int8_int32": 0, "qconv_int8_bf16_ulps": 0.0, "headline_f32_ulps": 0.0}
        for key, calls in sorted(counts.items()):
            cin, cout, k, h, w, images = key
            x, s, wq, scale, b, w32 = _qconv_operands(images, cin, cout, k, h, w, gen)
            x16, w16, b16 = x.bfloat16(), w32.bfloat16(), b.bfloat16()
            packed = qconv_ops.pack_weight(wq, qconv_ops.n_tile(cout))
            # At the main path's images per call a block runs many work items:
            # held exact here too, on the operands it is timed on.
            acc_p = qconv_ops.qconv_int8_plain(qconv_ops.quantize_int8_plain(x16, s), wq)
            d_int = int((qconv_ops.qconv_int8_cuda(x16, s, wq, packed).long() - acc_p.long()).abs().max())
            want16 = qconv_ops.dequantize_plain(acc_p, scale, b, torch.bfloat16).float()
            y16 = qconv_ops.qconv_int8_cuda(x16, s, wq, packed, scale, b, torch.bfloat16).float()
            ulps16 = float(((y16 - want16).abs() / bf16_ulp(want16)).max())
            at_batch["qconv_int8_int32"] = max(at_batch["qconv_int8_int32"], d_int)
            at_batch["qconv_int8_bf16_ulps"] = max(at_batch["qconv_int8_bf16_ulps"], ulps16)
            gate(d_int == 0, f"qconv_int8 {key}: int32 sums off the plain conv by {d_int}")
            gate(ulps16 <= 1.0, f"qconv_int8 {key}: bfloat16 output {ulps16} ulps off the plain epilogue")
            del acc_p, want16, y16

            def fused(x_, s_, wq_, scale_, b_):
                return qconv_ops.qconv_int8_cuda(x_, s_, wq_, packed, scale_, b_, torch.bfloat16)

            ms, base_ms = timed_in_turns(fused, (x16, s, wq, scale, b), base_fn, iters=5)
            cudnn_ms = cuda_ms(lambda: torch.nn.functional.conv2d(x16, w16, b16, padding=k // 2), iters=5)
            lib_ms = int_mm_ms(images, cin, cout, k, h, w, gen)
            bound, by = qconv_bound_ms(images, cin, cout, k, h, w, 2, 2, peak)
            row = dict(ms=ms, bound_ms=bound, cudnn_bf16_ms=cudnn_ms, library_ms=lib_ms)
            if base_fn is not None:
                row.update(baseline_ms=base_ms, baseline_bound_ms=unfused_bound_ms(images, cin, cout, k, h, w, 2, 2,
                                                                                    peak))
            emit("timing_qconv", shape=[cin, cout, k, h, w], images=images, calls_per_forward=calls, bound_by=by,
                 achieved_over_bound=bound / ms, library="torch._int_mm: GEMM alone, im2col not counted", **row)
            for name, val in row.items():
                totals[name] += calls * (val or 0.0)
            if key == QCONV_HEADLINE:
                y = qconv_ops.qconv_int8_cuda(x, s, wq, packed, scale, b, torch.float32)
                want = qconv_ops.qconv_int8_plain(qconv_ops.quantize_int8_plain(x, s), wq, scale, b, torch.float32)
                at_batch["headline_f32_ulps"] = float(((y - want).abs() / f32_ulp(want)).max())
                gate(at_batch["headline_f32_ulps"] <= 1.0,
                     f"qconv_int8 {key}: float32 output {at_batch['headline_f32_ulps']} ulps off the plain epilogue")
                plain_ms = cuda_ms(lambda: qconv_ops.qconv_int8_plain(qconv_ops.quantize_int8_plain(x16, s), wq, scale,
                                                                      b, torch.bfloat16), iters=1, warmup=1)
                headline = dict(shape=[cin, cout, k, h, w], images=images, plain_ms=plain_ms, bound_by=by,
                                max_abs_err=float((y - want).abs().max()), **row)
                del y, want
            del x, x16, w16, b16, wq, scale, b, w32, packed
            torch.cuda.empty_cache()
    gate(headline is not None, f"the headline conv {QCONV_HEADLINE} is not in TAI_gray's int8 schedule")
    emit("qconv_batch_checks", model="TAI_gray", batch=INT8_SERVE_B, distinct=len(counts), input="bfloat16",
         **at_batch)
    emit("timing_qconv_forward", model="TAI_gray", batch=INT8_SERVE_B, calls=len(schedule),
         distinct=len(counts), **{f"{k}_per_forward": v for k, v in totals.items()})
    emit("qconv_kernel", wall_s=time.perf_counter() - t0)
    return dict(headline=headline, totals=totals)


def int8_golden_state(golden) -> dict:
    """The golden's ``amax/<flax path>`` entries as a "quant" collection, converted."""
    tree = {}
    for key in golden.files:
        if key.startswith("amax/"):
            node = tree
            for part in key.split("/")[1:]:
                node = node.setdefault(part, {})
            node["act_amax"] = golden[key]
    return quant_from_jax(tree)


def _time_in_turns(fns: dict, iters: int = 5) -> dict:
    """CUDA-event ms of each callable, timed in turns (a, b, ..., b, a) and
    averaged, with the peak memory of each."""
    out = {name: [] for name in fns}
    mem = {}
    order = list(fns) + list(reversed(fns))
    for name in order:
        torch.cuda.reset_peak_memory_stats()
        out[name].append(cuda_ms(fns[name], iters=iters))
        mem[name] = torch.cuda.max_memory_allocated()
    return {name: (sum(v) / len(v), mem[name]) for name, v in out.items()}


def qconv_plain(m, x: torch.Tensor, plain) -> torch.Tensor:
    """The QConv ``m``'s call on ``x`` recomputed by the plain versions
    (``plain["quantize_int8_plain"]``, ``plain["qconv_int8_plain"]``) from the
    module's own scales (a static module's amax as it stands)."""
    amax = m.act_amax if m.static else x.abs().amax().float()
    x_scale = torch.clamp_min(amax * quant.INV_127, quant.EPS)
    wq, w_scale = m.quantized_weight()
    return plain["qconv_int8_plain"](plain["quantize_int8_plain"](x, x_scale), wq, x_scale * w_scale,
                                     m.bias.detach().float(), x.dtype)


def _calls_vs_plain(model, calls) -> float:
    """Each recorded QConv call (path, x, y) recomputed by the plain versions
    on the same input and the module's own scales: the worst |y - plain| in
    float32 ulps of the plain output."""
    worst = 0.0
    convs = quant.qconvs(model)
    for path, x, y in calls:
        want = qconv_plain(convs[path], x, vars(qconv_ops)).float()
        worst = max(worst, float(((y.float() - want).abs() / f32_ulp(want)).max()))
    return worst


def phase_serve_int8(state, gen) -> dict:
    """TAI_gray in vfi_tpu's int8 modes (VFI_INT8 at construction), f32 with
    TF32 off, on the golden inputs, against ``tests/torch_golden_tai_gray_int8.npz``
    and the float golden: static with the golden's scales (``quant_from_jax``),
    static with the port's own calibration from zero, and dynamic.  Gates:
    launches per forward from the run's own schedule; every int8 conv call of
    the forward, recomputed by the plain versions on its recorded input,
    within one float32 ulp; pred at uint8 PSNR >= 45 dB against vfi_tpu's
    int8 pred (static with its scales, dynamic); and the int8 mode's loss against the float32 golden within
    0.5 dB (vfi_tpu's --quant_tol_db) of vfi_tpu's own loss.  max-abs and
    the calibrated amax against the golden's are printed, not gated: the two
    packages' float noise flips int8 roundings in the rollout, and the
    flips move later scales (PERF.md §6).  Then bf16 timings beside the
    float forward, and TAI_color static at B=16.  Returns its paths' launches."""
    t0 = time.perf_counter()
    cfg = GOLDEN
    golden = np.load(INT8_GOLDEN_PATH)
    for k, val in cfg.items():
        gate(str(golden[k]) == str(val), f"int8 golden fixture {k}={golden[k]} but chip_smoke uses {val}")
    f32_golden = np.load(GOLDEN_PATH)["pred"]
    T = cfg["T"]
    p, f = (torch.from_numpy(a).cuda() for a in golden_inputs())
    amax = int8_golden_state(golden)
    paths, res = {}, {}
    for mode in ("static", "own_calibration", "dynamic"):
        ip = int8_inpainter(cfg["model_key"], state, "1" if mode == "dynamic" else "2", torch.float32)
        if mode == "static":
            quant.load_act_amax(ip.model, amax)
        elif mode == "own_calibration":  # from zero, on the same inputs
            with quant.calibrate(ip.model), uncounted(), torch.inference_mode():
                ip.model(T, p, f)
            mine = quant.act_amax_state(ip.model)
            gate(sorted(mine) == sorted(amax), "serve_int8: the port's static convs are not the golden's")
            rel = np.array([abs(float(mine[k]) - float(v)) / max(abs(float(v)), 1e-30) for k, v in amax.items()])
            res["calibration_rel"] = dict(max=float(rel.max()), median=float(np.median(rel)),
                                          over_1e_4=int((rel > 1e-4).sum()), act_amax=len(rel))
        recorded = []
        hooks = [m.register_forward_hook(lambda m, inp, out, n=n: recorded.append((n, inp[0].clone(), out.clone())))
                 for n, m in quant.qconvs(ip.model).items()]
        _reset_launch_counts()
        try:
            with torch.inference_mode():
                out = ip.model(T, p, f)
        finally:
            for hk in hooks:
                hk.remove()
        paths[f"serve_int8_{mode}"] = launches = _launch_counts()
        _gate_launches(f"serve_int8_{mode}", launches, {"qconv_int8": len(recorded), "sepconv_fwd_mxu": 2})
        with uncounted():
            ulps = _calls_vs_plain(ip.model, recorded)
        got = out["pred"].float().cpu().numpy()
        want = golden["pred_dynamic" if mode == "dynamic" else "pred_static"]
        res[mode] = dict(calls=len(recorded), calls_vs_plain_max_ulps=ulps, max_abs=float(np.abs(got - want).max()),
                         u8_psnr_db=u8_psnr(u8(got), u8(want)),
                         vs_f32_golden_u8_psnr_db=u8_psnr(u8(got), u8(f32_golden)),
                         vfi_tpu_vs_f32_golden_u8_psnr_db=u8_psnr(u8(want), u8(f32_golden)),
                         vfi_tpu_vs_f32_golden_max_abs=float(np.abs(want - f32_golden).max()))
        del ip, out, recorded
        torch.cuda.empty_cache()
    emit("serve_int8_golden", dtype="float32", tf32=False, **res)
    for mode in ("static", "own_calibration", "dynamic"):
        r = res[mode]
        gate(r["calls_vs_plain_max_ulps"] <= 1.0,
             f"serve_int8 {mode}: an int8 conv call {r['calls_vs_plain_max_ulps']} ulps off its plain recomputation")
        if mode != "own_calibration":  # other scales than the golden's: held by the loss alone
            gate(r["u8_psnr_db"] >= 45.0,
                 f"serve_int8 {mode}: pred uint8 PSNR {r['u8_psnr_db']} dB < 45 against the golden")
        loss = r["vfi_tpu_vs_f32_golden_u8_psnr_db"] - r["vs_f32_golden_u8_psnr_db"]
        gate(loss <= 0.5, f"serve_int8 {mode}: {loss} dB further from the float32 golden than vfi_tpu's int8 pred")
    torch.cuda.empty_cache()

    # bf16 timings: the float forward and the int8 forwards in turns.
    H, W = cfg["H"], cfg["W"]
    timings = []
    for B, modes in ((INT8_SERVE_B, ("static", "dynamic")), (8, ("static",))):
        pb = (torch.rand(B, cfg["K"], H, W, 1, device="cuda", generator=gen) * 2 - 1).bfloat16()
        fb = (torch.rand(B, cfg["F"], H, W, 1, device="cuda", generator=gen) * 2 - 1).bfloat16()
        ips = {"float": VideoInpainter(cfg["model_key"], state, device="cuda", dtype=torch.bfloat16)}
        for mode in modes:
            ips[mode] = int8_inpainter(cfg["model_key"], state, "2" if mode == "static" else "1", torch.bfloat16)
        with uncounted():
            if "static" in ips:
                with quant.calibrate(ips["static"].model), torch.inference_mode():
                    ips["static"].model(T, pb, fb)
            times = _time_in_turns({name: (lambda ip=ip: ip.forward(T, pb, fb)) for name, ip in ips.items()})
        for name, (ms, mem) in times.items():
            timings.append(dict(mode=name, batch=B, ms_per_batch=ms, middle_frames_per_s=B * T / (ms / 1e3),
                                max_memory_allocated_bytes=mem))
            emit("timing_serve_int8", model=cfg["model_key"], dtype="bfloat16", **timings[-1],
                 vs_float=times["float"][0] / ms)
        del ips, pb, fb
        torch.cuda.empty_cache()

    # TAI_color at 256x320, bf16, static (calibrated on its own batch), B=16.
    color = params_from_jax(random_jax_params("TAI_color", 0))
    ip = int8_inpainter("TAI_color", color, "2", torch.bfloat16)
    B, Hc, Wc = 16, 256, 320
    pc = (torch.rand(B, 5, Hc, Wc, 3, device="cuda", generator=gen) * 2 - 1).bfloat16()
    fc = (torch.rand(B, 5, Hc, Wc, 3, device="cuda", generator=gen) * 2 - 1).bfloat16()
    with quant.calibrate(ip.model), uncounted(), torch.inference_mode():
        ip.model(T, pc, fc)
    _reset_launch_counts()
    out, calls = int8_calls(ip.model, T, pc, fc)
    paths["serve_int8_color"] = launches = _launch_counts()
    _gate_launches("serve_int8_color", launches, {"qconv_int8": len(calls), "sepconv_fwd_mxu": 2})
    finite = bool(torch.isfinite(out["pred"]).all())
    gate(finite, "serve_int8_color: non-finite pred")
    flt = VideoInpainter("TAI_color", color, device="cuda", dtype=torch.bfloat16)
    with uncounted():
        times = _time_in_turns({"float": lambda: flt.forward(T, pc, fc), "static": lambda: ip.forward(T, pc, fc)})
    for name, (ms, mem) in times.items():
        emit("timing_serve_int8", model="TAI_color", dtype="bfloat16", mode=name, batch=B, shape=[Hc, Wc, 3],
             ms_per_batch=ms, middle_frames_per_s=B * T / (ms / 1e3), max_memory_allocated_bytes=mem,
             vs_float=times["float"][0] / ms)
    emit("serve_int8_color", calls=len(calls), finite=finite, **launches)
    del ip, flt, out, pc, fc
    torch.cuda.empty_cache()
    emit("serve_int8", wall_s=time.perf_counter() - t0)
    return paths


@contextlib.contextmanager
def stage_launches(record: dict):
    """Record the launches of the predict CLI's calibration and its
    --validate_quant gate (each stage's counts, taken around it)."""
    calibrate, validate = quant.calibrate, predict_cli._validate_quant

    @contextlib.contextmanager
    def counted_calibrate(model):
        before = _launch_counts()
        with calibrate(model):
            yield model
        record["calibration"] = {k: n - before[k] for k, n in _launch_counts().items()}

    def counted_validate(*args, **kwargs):
        before = _launch_counts()
        verdict = validate(*args, **kwargs)
        record["gate"] = {k: n - before[k] for k, n in _launch_counts().items()}
        return verdict

    quant.calibrate, predict_cli._validate_quant = counted_calibrate, counted_validate
    try:
        yield record
    finally:
        quant.calibrate, predict_cli._validate_quant = calibrate, validate


def phase_predict_int8(root: str, videolist: str, per_forward: int) -> dict:
    """The predict CLI from ``phase_predict``'s snapshot and clips in vfi_tpu's
    int8 modes: ``--quantize int8``, bf16 ``--device_normalize`` at B=64 with
    the default gate (calibration on 8 clips, the gate on 4), then
    ``--quantize int8_dynamic`` on 16 clips at B=16: the calibration and gate
    lines, every PNG, and the launches of calibration, gate and loop
    (``per_forward`` int8 convs in each int8 forward, 2 banded sepconv
    launches in every forward, the gate's float32 one included)."""
    t0 = time.perf_counter()
    cfg = PREDICT
    paths = {}
    runs = (("predict_int8", "int8", videolist, cfg["clips"], cfg["batch"], 8, 4),
            ("predict_int8_dynamic", "int8_dynamic", _head(videolist, 16, os.path.join(root, "list16_int8.txt")), 16,
             16, 0, 4))
    for path, mode, lst, clips, batch, n_cal, n_val in runs:
        qual = os.path.join(root, f"qual_{path}")
        stages = {}
        _reset_launch_counts()
        with stage_launches(stages):
            stats, stdout = run_predict(_predict_args(cfg, root, lst, qual, "bfloat16", batch,
                                                      ["--device_normalize", "--quantize", mode]))
        paths[path] = launches = _launch_counts()
        pngs = _pngs(qual)
        batches = -(-clips // batch)
        want = {"calibration": {"qconv_int8": per_forward if n_cal else 0, "sepconv_fwd_mxu": 2 if n_cal else 0},
                "gate": {"qconv_int8": per_forward, "sepconv_fwd_mxu": 4}}
        total = {k: sum(w.get(k, 0) for w in want.values()) + (per_forward * batches if k in QKERNELS else 0)
                 for k in COUNTED}
        total["sepconv_fwd_mxu"] += 2 * batches
        cal_line = f"int8 activation scales calibrated on {n_cal} clips"
        gate_line = f"validate_quant ({n_val} clips): PSNR f32"
        emit(path, dtype="bfloat16", batch=batch, clips=stats["clips"], batches=stats["batches"], folders=len(pngs),
             loop_s=stats["loop_s"], forward_s=stats["forward_s"],
             middle_frames_per_s=stats["clips"] * cfg["T"] / stats["loop_s"],
             calibration_line=cal_line in stdout,
             gate_line=[ln for ln in stdout.splitlines() if "validate_quant" in ln],
             stage_launches=stages, **launches)
        gate(len(pngs) == clips and all(len(v) == cfg["K"] + 2 * cfg["T"] + cfg["F"] for v in pngs.values()),
             f"{path} wrote {len(pngs)} folders of {sorted({len(v) for v in pngs.values()})} PNGs")
        gate((cal_line in stdout) == bool(n_cal), f"{path}: calibration line {'missing' if n_cal else 'printed'}")
        gate(gate_line in stdout and "REFUSED" not in stdout, f"{path}: the validate_quant line is missing")
        for stage, w in want.items():
            got = stages.get(stage, {})
            for k in COUNTED:
                gate(got.get(k, 0) == w.get(k, 0), f"{path} {stage}: {k} launched {got.get(k, 0)}, want {w.get(k, 0)}")
        _gate_launches(path, launches, total)
    emit("predict_int8", wall_s=time.perf_counter() - t0)
    return paths


# The reproduction path: a reference-format snapshot of the reference's
# TAI_gray at full width (tests/torch_mirror.py, seeded: the state_dict
# layout of a published model_best.ckpt) imported, served and scored.
REFERENCE = dict(model_key="TAI_gray", mirror_seed=0, input_seed=8, updates=150000, B=2, K=5, T=5, F=5, H=128,
                 W=128, clips=16, batch=8, of_clips=2)
REFERENCE_NAME = "imported_tai_gray"
DEAD_WEIGHTS = ["merge_residual1.res.0.bias", "merge_residual1.res.0.weight", "merge_residual1.res.2.bias",
                "merge_residual1.res.2.weight"]


def reference_weights_(mirror: torch.nn.Module, seed: int) -> None:
    """Redraw a mirror's weights in place, in state_dict order from one
    ``np.random.RandomState(seed)``, as ``random_jax_params`` draws the
    port's: conv and transposed-conv kernels He-normal, biases small normals,
    the kernel heads' last convs with small kernels and biases centred on
    1/ks (each per-pixel kernel sums to about 1).  torch's default init
    leaves TAI's outputs nearly constant, which would hide a wrong mapping."""
    rng = np.random.RandomState(seed)
    heads = {f"kernelnet.module{h}.7" for h in ("Vertical1", "Vertical2", "Horizontal1", "Horizontal2")}
    modules = dict(mirror.named_modules())
    with torch.no_grad():
        for name, t in mirror.state_dict().items():
            owner, leaf = name.rsplit(".", 1)
            m = modules[owner]
            fan_in = (m.in_channels * m.kernel_size[0] * m.kernel_size[1]) if hasattr(m, "in_channels") else t.shape[-1]
            if leaf == "weight":
                std = 0.5 / t.shape[0] / np.sqrt(fan_in) if owner in heads else np.sqrt(2.0 / fan_in)
                a = rng.standard_normal(tuple(t.shape)) * std
            else:
                a = rng.standard_normal(tuple(t.shape)) * 0.01 + (1.0 / t.shape[0] if owner in heads else 0.0)
            t.copy_(torch.from_numpy(a.astype(np.float32)))


# The plain versions a CUDA path must never call: the sepconv forwards (by
# the dispatcher or ``SepConv``) and the int8 quantize and conv (by
# ``ops.qconv.qconv_int8``).
PLAIN = {"sepconv_banded": sepconv_ops, "sepconv_direct": sepconv_ops, "quantize_int8_plain": qconv_ops,
         "qconv_int8_plain": qconv_ops}


@contextlib.contextmanager
def plain_calls():
    """Counts the calls of the ``PLAIN`` functions made inside through their
    modules; yields (the counts, the functions themselves, for checks that
    call them uncounted)."""
    calls = dict.fromkeys(PLAIN, 0)
    saved = {n: getattr(module, n) for n, module in PLAIN.items()}

    def counted(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return saved[name](*args, **kwargs)
        return call

    for name, module in PLAIN.items():
        setattr(module, name, counted(name))
    try:
        yield calls, saved
    finally:
        for name, fn in saved.items():
            setattr(PLAIN[name], name, fn)


def phase_reference_import(root: str, videolist: str, card: str) -> dict:
    """The paper's reproduction path on the card: a
    ``tests/torch_mirror.py`` TAI_gray (gf 64, ks 51, num_block 5, kf 32)
    with seeded weights (:func:`reference_weights_`) saved as a reference
    snapshot (``updates``, the two error sums,
    ``generator``, ``optimizer_G``) goes through
    ``cli.import_torch_checkpoint``; its f32 forward through
    ``VideoInpainter.from_checkpoint`` against the mirror's own forward on the
    card (unfold sepconv) at B=2, K=T=F=5, 128x128, TF32 off: the forward
    gates, 2 banded launches and no plain sepconv; then ``cli.predict`` from
    the snapshot in bf16 on 16 of ``phase_predict``'s clips,
    ``cli.compute_quant_results`` on the card and ``cli.summarize_quant_results``'
    two text tables against numpy's means and standard errors of the same
    results.npz; and ``OFFillInModel``: the ImportError naming OpenCV or
    scipy where they are missing, else two clips served.  Returns the
    launches of the forward and of the predict run."""
    cfg = REFERENCE
    K, T, F, B, H, W = cfg["K"], cfg["T"], cfg["F"], cfg["B"], cfg["H"], cfg["W"]
    seconds, paths = {}, {}
    t_phase = time.perf_counter()
    mirror = torch_mirror.TAIFillInModel(64, 1, 3, 51, num_block=5, kf_dim=32).eval()
    reference_weights_(mirror, cfg["mirror_seed"])
    src = os.path.join(root, "reference", "model_best.ckpt")
    os.makedirs(os.path.dirname(src), exist_ok=True)
    torch.save({"updates": cfg["updates"], "sum_avg_psnr_err": 0.0, "sum_avg_ssim_err": 0.0,
                "generator": mirror.state_dict(),
                "optimizer_G": torch.optim.Adam(mirror.parameters()).state_dict()}, src)

    dest = os.path.join(root, "ckpt", REFERENCE_NAME)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        imported = import_cli.main([src, "--model_key", cfg["model_key"], "--dest_dir", dest])
    seconds["import_s"] = time.perf_counter() - t0
    with torch.device("meta"):
        n_tensors = len(create_model(cfg["model_key"]).state_dict())
    report = imported["report"]
    emit("reference_import_cli", converted=report.converted, skipped=sorted(report.skipped),
         params=imported["params"], snapshot_bytes=os.path.getsize(os.path.join(dest, "model_best.ckpt",
                                                                                ckpt.PAYLOAD)))
    gate(report.converted == n_tensors, f"the import converted {report.converted} tensors, the model has {n_tensors}")
    gate(sorted(report.skipped) == DEAD_WEIGHTS, f"the import skipped {sorted(report.skipped)}")

    # The imported f32 forward against the mirror's, both on the card, TF32 off.
    rng = np.random.RandomState(cfg["input_seed"])
    p = rng.uniform(-1, 1, (B, K, H, W, 1)).astype(np.float32)
    f = rng.uniform(-1, 1, (B, F, H, W, 1)).astype(np.float32)
    ip = VideoInpainter.from_checkpoint(cfg["model_key"], dest, dtype=torch.float32, device="cuda")
    pc, fc = torch.from_numpy(p).cuda(), torch.from_numpy(f).cuda()
    torch.cuda.synchronize()
    _reset_launch_counts()
    with plain_calls() as (plain, _), torch.inference_mode():
        t0 = time.perf_counter()
        out = ip.model(T, pc, fc)
        torch.cuda.synchronize()
        seconds["forward_s"] = time.perf_counter() - t0
    paths["reference_import"] = _launch_counts()
    out = {k: v.float().cpu().numpy() for k, v in out.items()}
    del ip, pc, fc
    mirror.cuda()
    with torch.device("cuda"), torch.no_grad():  # the mirror makes its LSTM state with torch.zeros
        t0 = time.perf_counter()
        ref = mirror(T, torch.from_numpy(p.transpose(0, 1, 4, 2, 3)).cuda(),
                     torch.from_numpy(f.transpose(0, 1, 4, 2, 3)).cuda())
        torch.cuda.synchronize()
        seconds["mirror_forward_s"] = time.perf_counter() - t0
    ref = {k: v.permute(0, 1, 3, 4, 2).float().cpu().numpy() for k, v in ref.items()}
    del mirror
    torch.cuda.empty_cache()
    res = {k: (float(np.abs(out[k] - ref[k]).max()), u8_psnr(u8(out[k]), u8(ref[k]))) for k in ref}
    emit("reference_import_forward", dtype="float32", tf32=False, batch=B, shape=[H, W, 1], plain_calls=plain,
         **{f"{k}_std": float(ref[k].std()) for k in ref}, **{f"{k}_max_abs": v[0] for k, v in res.items()}, **{f"{k}_u8_psnr_db": v[1] for k, v in res.items()},
         **paths["reference_import"])
    gate(sorted(res) == sorted(out), f"the port's outputs {sorted(out)}, the mirror's {sorted(res)}")
    for key, (err, psnr) in res.items():
        gate(err <= 5e-3, f"reference_import: {key} max_abs {err} > 5e-3 against the mirror")
        gate(psnr >= 45.0, f"reference_import: {key} uint8 PSNR {psnr} dB < 45 against the mirror")
    gate(not any(plain.values()), f"reference_import: a plain version ran: {plain}")
    _gate_launches("reference_import", paths["reference_import"], {"sepconv_fwd_mxu": 2})

    # Serve, score, summarize.
    lst = _head(videolist, cfg["clips"], os.path.join(root, "list_reference.txt"))
    qual, quant_root, tables = (os.path.join(root, d) for d in ("qual_reference", "quant_reference", "tables"))
    _reset_launch_counts()
    t0 = time.perf_counter()
    stats, _ = run_predict(_predict_args(PREDICT, root, lst, qual, "bfloat16", cfg["batch"],
                                         ["--device_normalize", "--name", REFERENCE_NAME]))
    seconds["predict_s"] = time.perf_counter() - t0
    seconds["predict_loop_s"] = stats["loop_s"]
    paths["reference_predict"] = _launch_counts()
    pngs = _pngs(qual)
    gate(len(pngs) == cfg["clips"] and all(len(v) == K + 2 * T + F for v in pngs.values()),
         f"reference predict wrote {len(pngs)} folders of {sorted({len(v) for v in pngs.values()})} PNGs")
    _gate_launches("reference_predict", paths["reference_predict"],
                   {"sepconv_fwd_mxu": 2 * (cfg["clips"] // cfg["batch"])})
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        quant_cli.main([qual, quant_root, str(K), str(T)])
    seconds["quant_s"] = time.perf_counter() - t0
    label = "imported_TAI_gray"
    t0 = time.perf_counter()
    for metric in ("psnr", "ssim"):
        for cmd in ("metric_summary_text_file", "video_metric_text_file"):
            summarize_cli.main([cmd, "--quant_results_roots", quant_root, "--labels", label, "--dest_path", tables,
                                "--metric", metric])
    seconds["summarize_s"] = time.perf_counter() - t0
    z = np.load(os.path.join(quant_root, "results.npz"))
    table_rows = {}
    for metric in ("psnr", "ssim"):
        per_video = np.minimum(z[metric], 100.0).mean(axis=1) if metric == "psnr" else z[metric].mean(axis=1)
        want = ["%.2f" % per_video.mean(), "%.3f" % (per_video.std() / np.sqrt(per_video.size))]
        with open(os.path.join(tables, f"{metric}_perf_summary.txt")) as fh:
            rows = [[c.strip() for c in ln.strip("|").split("|")] for ln in fh.read().splitlines() if ln.startswith("|")]
        table_rows[metric] = rows
        gate(rows == [["Model", "Mean", "StdErr"], [label, *want]], f"{metric} table {rows}, numpy {want}")
        with open(os.path.join(tables, f"sorted_{metric}_scores.txt")) as fh:
            lines = fh.read().splitlines()
        scores = [float(ln.rsplit(", ", 1)[1]) for ln in lines[1:] if ln]
        gate(lines[0] == f"{label}:" and np.allclose(scores, np.sort(per_video), rtol=1e-12, atol=0),
             f"sorted_{metric}_scores.txt is not numpy's per-video means")
    emit("reference_predict", dtype="bfloat16", batch=cfg["batch"], clips=stats["clips"],
         psnr_mean_db=float(z["psnr"].mean()), ssim_mean=float(z["ssim"].mean()), tables=table_rows,
         **paths["reference_predict"])

    # The optical-flow baseline: host code that needs OpenCV and scipy.
    try:
        create_model("OFFillInModel")
        import cv2
        import scipy
    except ImportError as e:
        outcome = f"not built: ImportError({e})"
        gate(e.name in ("cv2", "scipy.spatial") and ("OpenCV" in str(e) or "scipy" in str(e)),
             f"OFFillInModel's ImportError names no package: {e!r}")
    else:
        lst2 = _head(videolist, cfg["of_clips"], os.path.join(root, "list_of.txt"))
        qual_of = os.path.join(root, "qual_of")
        _reset_launch_counts()
        run_predict(_predict_args(PREDICT, root, lst2, qual_of, "float32", cfg["of_clips"],
                                  ["--model_key", "OFFillInModel"]))
        of_pngs = _pngs(qual_of)
        gate(len(of_pngs) == cfg["of_clips"] and all(len(v) == K + 2 * T + F for v in of_pngs.values()),
             f"OFFillInModel wrote {len(of_pngs)} folders")
        _gate_launches("reference_of", _launch_counts(), {})
        outcome = f"served {len(of_pngs)} clips (OpenCV {cv2.__version__}, scipy {scipy.__version__})"
    print(f"OFFillInModel: {outcome}", flush=True)
    emit("reference_import", nvidia_smi=card, offillinmodel=outcome, wall_s=time.perf_counter() - t_phase,
         host_packages={m: importlib.util.find_spec(m) is not None for m in ("cv2", "scipy", "matplotlib", "PIL")},
         **seconds)
    return paths


# The figure and animation tools (eval/animate, eval/figures, eval/records
# and the six CLIs on them) fed by predict's snapshot and clips: TAI_gray at
# bf16 with --intermediate_preds, at --quantize none and int8.  The layout of
# compare_visual_results' video frames: 320x240 frames, 4-pixel borders and
# padding, 20 pixels between the labels and the frames.
FIGURES = dict(clips=4, batch=4, dataset="KTH", shown=2, io_key="5_10", frame_indexes=(0, 5, 7, 10, 14),
               exps={"none": "tai_gray_bf16", "int8": "tai_gray_int8"}, models={"none": "bi-TAI", "int8": "bi-TAI int8"})
VIDEO_FRAME, VIDEO_BORDER, VIDEO_PADDING, VIDEO_LABEL_PAD, LABEL_H = (320, 240), 4, 4, 20, 18
HOST_PACKAGES = ("cv2", "PIL", "imageio", "matplotlib")
# The predict CLI's --validate_quant line (its scores of the quantized and the float32 model).
VALIDATE_LINE = re.compile(r"validate_quant \(\d+ clips\): PSNR f32 ([-0-9.]+) -> quantized ([-0-9.]+) dB .*"
                           r"agreement ([-0-9.]+) dB")


def host_packages() -> dict:
    """{package: its version, or None where it is not installed}."""
    found = {}
    for name in HOST_PACKAGES:
        try:
            found[name] = str(getattr(importlib.import_module(name), "__version__", "installed"))
        except ImportError:
            found[name] = None
    return found


def run_tool(name: str, needs: tuple, fn, found: dict, seconds: dict) -> bool:
    """Run one tool (its stdout kept back).  Where a package in ``needs`` is
    missing it must raise the ImportError that names it (gated); returns
    whether it ran."""
    missing = [m for m in needs if found[m] is None]
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            fn()
    except ImportError as e:
        gate(e.name in missing and f"needs {e.name}, which is not installed" in str(e),
             f"figures: {name} raised {e!r}, with {missing or 'no package'} missing")
        ran = False
    else:
        gate(not missing, f"figures: {name} ran without {missing}")
        ran = True
    seconds[f"{name}_s"] = time.perf_counter() - t0
    return ran


def _rgb(a: np.ndarray) -> np.ndarray:
    return np.repeat(a.reshape(a.shape[0], a.shape[1], -1), 3, axis=2) if a.ndim == 2 or a.shape[-1] == 1 else a


def phase_figures(root: str, videolist: str, per_forward: int, card: str) -> dict:
    """The figure and animation tools on the card's machine, fed by
    ``cli.predict`` at TAI_gray's full width (``phase_predict``'s snapshot,
    its first 4 clips, bf16 ``--device_normalize --intermediate_preds`` at
    B=4) under two experiment names, ``--quantize none`` and ``int8``: 2
    banded launches per forward, ``per_forward`` int8 conv launches per int8
    forward (calibration, the gate's int8 forward, the loop), no plain
    sepconv or int8 call, every intermediate PNG; then
    ``cli.compute_quant_results`` on the card; then the tools, each output's
    frame count and size computed from K, T, F and the layout, the image
    strip pixel for pixel against the source PNGs (read by ``utils/png.py``);
    the tools whose optional package (imageio, OpenCV, matplotlib) is
    missing must raise the ImportError that names it.  Returns the launches
    of the two predict runs."""
    from PIL import Image

    from vfi_tpu_torch.cli import animate_qual_results as animate_cli
    from vfi_tpu_torch.cli import compare_intermediate_preds as intermediate_cli
    from vfi_tpu_torch.cli import compare_visual_results as visual_cli
    from vfi_tpu_torch.cli import generate_comparison_videos as comparison_cli
    from vfi_tpu_torch.cli import generate_unified_boxplot_fig as boxplot_cli
    from vfi_tpu_torch.cli import paper_figures as paper_cli

    cfg, pcfg = FIGURES, PREDICT
    K, T, F, hw = pcfg["K"], pcfg["T"], pcfg["F"], pcfg["hw"]
    n = K + T + F
    t_phase = time.perf_counter()
    found = host_packages()
    print(f"figures: host packages {found}", flush=True)
    base = os.path.join(root, "figures")
    results, out = os.path.join(base, "results"), os.path.join(base, "out")
    lst = _head(videolist, cfg["clips"], os.path.join(root, "list_figures.txt"))
    clips = [f"clip{i}.npy_1-{pcfg['frames']}" for i in range(cfg["clips"])]
    shown = clips[:cfg["shown"]]
    exps = list(cfg["exps"].values())
    names = sorted([f"gt_preceding_{t:04d}.png" for t in range(K)] + [f"gt_following_{t:04d}.png" for t in range(K + T, n)]
                   + [f"{prefix}_{t:04d}.png" for prefix in ("gt_middle", "pred_middle") + tuple(
                       p for _, p in predict_cli.INTERMEDIATE_PREDS) for t in range(K, K + T)])
    seconds, paths = {}, {}

    # 1. Predict, under two experiment names.
    batches = -(-cfg["clips"] // cfg["batch"])
    for mode, exp in cfg["exps"].items():
        qual = os.path.join(results, cfg["dataset"], "images", exp)
        int8 = mode != "none"
        stages = {}
        _reset_launch_counts()
        t0 = time.perf_counter()
        with plain_calls() as (plain, _), stage_launches(stages):
            stats, stdout = run_predict(_predict_args(pcfg, root, lst, qual, "bfloat16", cfg["batch"], [
                "--device_normalize", "--intermediate_preds", "--quantize", mode]))
        seconds[f"predict_{mode}_s"] = time.perf_counter() - t0
        path = f"figures_predict_{mode}"
        paths[path] = launches = _launch_counts()
        pngs = _pngs(qual)
        gate_lines = [ln for ln in stdout.splitlines() if VALIDATE_LINE.search(ln)]
        emit("figures_predict", quantize=mode, experiment=exp, dtype="bfloat16", batch=cfg["batch"],
             clips=stats["clips"], loop_s=stats["loop_s"], forward_s=stats["forward_s"], stage_launches=stages,
             plain_calls=plain, gate_line=gate_lines, pngs_per_folder=sorted({len(v) for v in pngs.values()}),
             **launches)
        gate(not any(plain.values()), f"figures {mode}: a plain version ran: {plain}")
        gate(sorted(pngs) == clips and all(v == names for v in pngs.values()),
             f"figures {mode}: wrote {sorted(pngs)} with {sorted({len(v) for v in pngs.values()})} PNGs each, "
             f"want {clips} with the {len(names)} names of K, T, F and --intermediate_preds")
        forwards = batches + (2 if int8 else 0)  # + calibration and the gate's int8 forward
        _gate_launches(path, launches, {"sepconv_fwd_mxu": 2 * forwards + (2 if int8 else 0),  # + the gate's f32 one
                                        "qconv_int8": per_forward * forwards if int8 else 0})
        if int8:
            gate(len(gate_lines) == 1 and "REFUSED" not in stdout, f"figures int8: validate_quant lines {gate_lines}")
            for stage, want in (("calibration", per_forward), ("gate", per_forward)):
                got = stages.get(stage, {}).get("qconv_int8", 0)
                gate(got == want, f"figures int8 {stage}: qconv_int8 launched {got}, want {want}")

    # 2. Score, on the card: results.npz under the boxplot's layout, copied to paper_figures plot's.
    t0 = time.perf_counter()
    for exp in exps:
        quant_root = os.path.join(results, f"{cfg['dataset']}-test_data_list_T={T}", "quantitative", exp)
        with contextlib.redirect_stdout(io.StringIO()):
            quant_cli.main([os.path.join(results, cfg["dataset"], "images", exp), quant_root, str(K), str(T)])
        z = np.load(os.path.join(quant_root, "results.npz"))
        gate(z["psnr"].shape == (cfg["clips"], T) and bool(np.isfinite(z["psnr"]).all() & np.isfinite(z["ssim"]).all()),
             f"figures: {exp}'s results.npz psnr {z['psnr'].shape}")
        plot_root = os.path.join(results, "quantitative", cfg["dataset"], exp)
        os.makedirs(plot_root, exist_ok=True)
        shutil.copy(os.path.join(quant_root, "results.npz"), plot_root)
    seconds["score_s"] = time.perf_counter() - t0

    # 3-4. The tools.
    visual = ["--results_root", results, "--dataset_name", cfg["dataset"], "--clip_names", *shown, "--exp_names",
              *exps, "--total_num_frames", str(n)]
    registry = os.path.join(out, "records", "experiments.json")
    font = visual_cli._font(40)
    label_w = max(visual_cli._text_width_px(font, label) for label in exps + ["Ground truth"])
    (fw, fh), b, pad = VIDEO_FRAME, VIDEO_BORDER, VIDEO_PADDING
    canvas = (label_w + VIDEO_LABEL_PAD + len(shown) * (fw + 2 * b) + (len(shown) - 1) * pad,
              (len(exps) + 1) * (fh + 2 * b) + len(exps) * pad)
    frames = {}

    def gif(path, size):
        with Image.open(path) as im:
            frames[os.path.relpath(path, base)] = (im.n_frames, im.size)
            gate((im.n_frames, im.size) == (n, size), f"figures: {path} has {im.n_frames} frames of {im.size}, "
                                                      f"want {n} of {size}")

    qual_none = os.path.join(results, cfg["dataset"], "images", exps[0])
    if run_tool("animate_qual_results", ("imageio",), lambda: animate_cli.main(
            [qual_none, "--create_gt_gif", "--num_workers", "2"]), found, seconds):
        for clip in clips:
            for name in ("pred_final.gif", "gt.gif"):
                gif(os.path.join(qual_none, clip, name), (hw, hw))
    if run_tool("generate_comparison_videos", ("imageio",), lambda: comparison_cli.main(
            ["--results_root", os.path.join(results, cfg["dataset"]), "--exp_names", *exps, "--clip_names", *shown,
             "--save_root", os.path.join(out, "comparison")]), found, seconds):
        for clip in shown:
            gif(os.path.join(out, "comparison", f"{clip}.gif"), (hw, len(exps) * (hw + LABEL_H)))
    if run_tool("compare_visual_results_gif", ("imageio",), lambda: visual_cli.main(
            visual + ["--dest_path", os.path.join(out, "gif"), "--no_pdf", "--video_type", "gif"]), found, seconds):
        gif(os.path.join(out, "gif", "video.gif"), canvas)
    if run_tool("compare_visual_results_mp4", ("cv2",), lambda: visual_cli.main(
            visual + ["--dest_path", os.path.join(out, "mp4"), "--no_pdf", "--video_type", "mp4"]), found, seconds):
        import cv2

        cap = cv2.VideoCapture(os.path.join(out, "mp4", "video.mp4"))
        sizes = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            sizes.append((frame.shape[1], frame.shape[0]))
        cap.release()
        frames["out/mp4/video.mp4"] = (len(sizes), sorted(set(sizes)))
        gate(len(sizes) == n and set(sizes) == {canvas}, f"figures: video.mp4 decoded to {len(sizes)} frames of "
                                                         f"{sorted(set(sizes))}, want {n} of {canvas}")
    run_tool("compare_visual_results_images_uncomp", (), lambda: visual_cli.main(
        visual + ["--dest_path", os.path.join(out, "uncomp"), "--no_pdf", "--video_type", "images-uncomp"]),
        found, seconds)
    uncomp = sorted(os.listdir(os.path.join(out, "uncomp", "video_frames")))
    sizes = {Image.open(os.path.join(out, "uncomp", "video_frames", u)).size for u in uncomp}
    frames["out/uncomp/video_frames"] = (len(uncomp), sorted(sizes))
    gate(uncomp == [f"{t:02d}.png" for t in range(n)] and sizes == {canvas},
         f"figures: images-uncomp wrote {uncomp} of {sorted(sizes)}, want {n} frames of {canvas}")

    def register():
        for mode, exp in cfg["exps"].items():
            paper_cli.main(["register", "--registry", registry, "--dataset", cfg["dataset"], "--model",
                            cfg["models"][mode], "--io_key", cfg["io_key"], "--exp_name", exp])

    run_tool("paper_figures_register", (), register, found, seconds)
    with open(registry) as fh_:
        reg = json.load(fh_)
    gate(reg == {cfg["dataset"]: {cfg["models"][m]: {cfg["io_key"]: [e]} for m, e in cfg["exps"].items()}},
         f"figures: the registry holds {reg}")
    strip = os.path.join(out, "strip.png")
    clip_dirs = [os.path.join(results, cfg["dataset"], "images", e, shown[0]) for e in exps]
    run_tool("paper_figures_images", (), lambda: paper_cli.main(["images", "--clip_dirs", *clip_dirs, "--output",
                                                                 strip]), found, seconds)
    seq = [("gt_preceding", t) for t in range(K)] + [("pred_middle", t) for t in range(K, K + T)] + [
        ("gt_following", t) for t in range(K + T, n)]
    want = np.concatenate([np.concatenate([_rgb(read_png(os.path.join(d, f"{p}_{t:04d}.png"))) for p, t in seq], 1)
                           for d in clip_dirs], 0)
    got = np.asarray(Image.open(strip))
    frames["out/strip.png"] = list(got.shape)
    gate(got.shape == (len(exps) * hw, n * hw, 3) and np.array_equal(got, want),
         f"figures: the image strip {got.shape} is not its source PNGs {want.shape} pixel for pixel")

    written = {}
    for name, fn, files in (
            ("compare_intermediate_preds_bidirectional", lambda: intermediate_cli.main(
                ["--results_root", results, "--dataset_name", cfg["dataset"], "--clip_names", shown[0],
                 "--exp_names", *exps, "--ts", *map(str, range(K, K + T)), "--dest_path",
                 os.path.join(out, "bidirectional"), "bidirectional_pred"]),
             [os.path.join("bidirectional", shown[0], f"{t:02d}.pdf") for t in range(K, K + T)]),
            ("compare_intermediate_preds_interp_net", lambda: intermediate_cli.main(
                ["--results_root", results, "--dataset_name", cfg["dataset"], "--clip_names", shown[0],
                 "--exp_names", *exps, "--ts", *map(str, range(K, K + T)), "--dest_path",
                 os.path.join(out, "interp_net"), "interp_net_pred"]),
             [os.path.join("interp_net", shown[0], f"{t:02d}.pdf") for t in range(K, K + T)]),
            ("compare_visual_results_pdf", lambda: visual_cli.main(
                visual[:-2] + ["--frame_indexes", *map(str, cfg["frame_indexes"]), "--dest_path",
                               os.path.join(out, "pdf")]),
             [os.path.join("pdf", f"{clip}.pdf") for clip in shown]),
            ("paper_figures_plot", lambda: paper_cli.main(
                ["plot", "--registry", registry, "--results_dir", results, "--output_dir", os.path.join(out, "plots"),
                 "--dataset", cfg["dataset"], "--models", *cfg["models"].values(), "--io_key", cfg["io_key"]]),
             [os.path.join("plots", f"{cfg['dataset']}_{cfg['io_key']}_{m}.pdf") for m in ("psnr", "ssim")]),
            ("generate_unified_boxplot_fig", lambda: boxplot_cli.main(
                ["--results_root", results, "--dest_path", os.path.join(out, "boxplot.pdf"), "--dataset",
                 cfg["dataset"], "--T_a", str(T), "--T_b", str(T), "--exp_names", *exps, "--model_labels",
                 *cfg["models"].values(), "--psnr_range", "0", "100", "--ssim_range", "0", "1"]),
             ["boxplot.pdf"])):
        if run_tool(name, ("matplotlib",), fn, found, seconds):
            for f in files:
                size = os.path.getsize(os.path.join(out, f)) if os.path.isfile(os.path.join(out, f)) else 0
                written[f] = size
                gate(size > 0, f"figures: {name} did not write {f}")
    seconds["phase_s"] = time.perf_counter() - t_phase
    emit("figures", nvidia_smi=card, host_packages=found, outputs=frames, pdfs=written, **seconds)
    print("figures seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()), flush=True)
    return paths


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


def _start_snapshot(root: str, name: str, start: str = "start") -> None:
    """The start snapshot (``<root>/<start>``, updates 0) as ``<root>/ckpt/<name>/model_latest.ckpt``."""
    shutil.copytree(os.path.join(root, start, "model_latest.ckpt"),
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
    the KTH run (bf16, --device_normalize, --sample_KTF, B=8: 20 iterations,
    then a resume to 30), an f32 run against ``TAIEnvironment.train_step``
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

    # The KTH run: snapshots every 10, validation every 15, resumed at 20.
    _start_snapshot(root, "kth")
    freq = ("--save_latest_freq", "10", "--validate_freq", "15")
    _reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    stats = [run_train(_train_cli_args(root, "kth", lists, *bf16, *freq, "--max_iter", str(n)))[0] for n in (20, 30)]
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
    gate([e["iter"] for e in iters] == list(range(1, 31)), f"train_cli logged iterations {[e['iter'] for e in iters]}")
    gate(finite, "train_cli: non-finite loss terms")
    gate(resumes == [0, 20], f"train_cli resume events at {resumes}, want [0, 20]")
    gate(len(vals) == 6 and bests, f"train_cli: {len(vals)} val events, best at {bests}")
    gate({"model_latest.ckpt", "model_00000010.ckpt", "model_00000020.ckpt", "model_00000030.ckpt",
          "model_best.ckpt"} <= set(snapshots), f"train_cli snapshots {snapshots}")
    gate(counters["updates"] == 30, f"model_latest.ckpt at updates {counters['updates']}")
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
    init, 10 warm-up and 30 timed iterations at --print_freq 10, at fixed
    K=T=F=5 and under --sample_KTF.  ms/it is the median of the print windows
    after the first, beside the ``train`` phase's ms per step (the step alone
    on one fixed batch); the host's seconds: waiting for the prefetcher,
    copying and normalising, dispatching the steps, the sync at each print;
    at fixed K, T, F one validation sweep and one snapshot save at iteration
    40; where a
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
    every = ("--save_latest_freq", "40", "--validate_freq", "40")
    never = ("--save_latest_freq", "1000", "--validate_freq", "1000")
    modes = (("fixed", KTH_FIXED_ARGS, every, False), ("sample_KTF", KTH_ARGS, never, False),
             ("fixed_no_writer", KTH_FIXED_ARGS, never, True),
             ("fixed_no_writer_device_cache", KTH_FIXED_ARGS, never + ("--device_cache", "8"), True))
    for mode, base, extra, blind in modes:
        name = f"timing_{mode}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with uncounted(), (no_tensorboard() if blind else contextlib.nullcontext()):
            stats, _ = run_train(_train_cli_args(
                root, name, lists, "--train_dtype", "bfloat16", "--device_normalize", "--max_iter", "40",
                "--print_freq", "10", *extra, base=base))
        windows = [e["ms_per_it"] for e in _events(root, name, "iter")]
        ms = float(np.median(windows[1:]))
        rng = np.random.RandomState(0)  # the CLI's --seed: its (K, T, F) draws
        T_all = [c["T"]] * 40 if mode.startswith("fixed") else [
            (rng.randint(2, c["K"] + 1), rng.randint(1, c["T"] + 1), rng.randint(2, c["F"] + 1))[1] for _ in range(40)]
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


# Data parallelism: the train and predict CLIs launched by torchrun as rank
# processes of this script (``--rank_worker``), which run each job's ``main``
# in-process and record what the CLI's own output does not show per rank.
DDP = dict(world=2, val_clips=15, batch=4, iters=20, resume_to=30, every=10, f32_iters=3, f32_batch=2)


def _state_digest(state) -> str:
    """sha256 of a training state's bytes: both networks' parameters and
    buffers, both optimizers' state, the step and the random generator."""
    h = hashlib.sha256()
    tensors = [*state.generator.state_dict().values(), *state.discriminator.state_dict().values()]
    for opt in (state.g_opt, state.d_opt):
        for p in (q for g in opt.param_groups for q in g["params"]):
            tensors += [opt.state[p][k] for k in sorted(opt.state[p])]
    for t in tensors:
        h.update(t.detach().reshape(-1).cpu().view(torch.uint8).numpy().tobytes())
    h.update(str(state.step).encode())
    if state.rng is not None:
        h.update(state.rng.get_state().numpy().tobytes())
    return h.hexdigest()


def _rank_job(job: dict) -> dict:
    """One CLI run of this rank: its stats and stdout, the kernel launches, the
    (K, T, F) of every step, the snapshots this rank saved, the bytes of each
    gradient all-reduce and the digest of the final training state."""
    from vfi_tpu_torch.train import environments

    record = {"name": job["name"], "ktf": [], "saves": [], "allreduce_bytes": []}
    last = {}
    make_env, save, allreduce = train_cli.create_training_environment, ckpt.save_snapshot, environments.allreduce_mean_

    def recording_env(*args, **kwargs):
        env = make_env(*args, **kwargs)
        step = env.train_step

        def train_step(state, K, T, F, targets):
            record["ktf"].append([K, T, F])
            last["state"] = state
            return step(state, K, T, F, targets)

        env.train_step = train_step
        return env

    def recording_save(save_dir, name, *args):
        record["saves"].append(name)
        return save(save_dir, name, *args)

    def recording_allreduce(tensors, group):
        record["allreduce_bytes"].append(sum(t.numel() * t.element_size() for t in tensors))
        return allreduce(tensors, group)

    train_cli.create_training_environment, ckpt.save_snapshot = recording_env, recording_save
    environments.allreduce_mean_ = recording_allreduce
    _reset_launch_counts()
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            stats = (train_cli if job["cli"] == "train" else predict_cli).main(job["args"])
    finally:
        train_cli.create_training_environment, ckpt.save_snapshot = make_env, save
        environments.allreduce_mean_ = allreduce
    torch.cuda.synchronize()
    record.update(stats=stats, stdout=out.getvalue(), launches=_launch_counts())
    if "state" in last:
        record["digest"] = _state_digest(last["state"])
    return record


def rank_worker(argv) -> int:
    """``chip_smoke.py --rank_worker JOBS OUT [--nccl] [--deterministic]``
    under torchrun: this rank runs the CLI jobs listed in the JSON file JOBS
    and writes ``OUT/rank<RANK>.json``.  Jobs with ``"group": false`` run
    first, in one process with no process group; then the first call of
    ``parallel.init_distributed`` (the rank's own, on its card) sets up the
    launch's group, which every other job's CLI uses.  With ``--nccl`` (a
    launch of one rank, whose WORLD_SIZE=1 sets up nothing) the group is
    NCCL's, made here.  ``--deterministic``: torch's deterministic algorithms
    (with ``CUBLAS_WORKSPACE_CONFIG`` set by the launch), so that two runs of
    one f32 program give the same bits."""
    import torch.distributed as dist

    from vfi_tpu_torch.parallel import mesh

    jobs_path, out_dir = argv[0], argv[1]
    local = int(os.environ["LOCAL_RANK"])  # ranks beyond the card count share card 0
    device = torch.device("cuda", local if local < torch.cuda.device_count() else 0)
    torch.cuda.set_device(device)
    torch.use_deterministic_algorithms("--deterministic" in argv)
    with open(jobs_path) as f:
        jobs = json.load(f)
    records = [_rank_job(job) for job in jobs if not job["group"]]
    if "--nccl" in argv:
        dist.init_process_group("nccl")  # WORLD_SIZE=1: init_distributed alone would set up nothing
    groups = mesh.init_distributed(device)
    try:
        records += [_rank_job(job) for job in jobs if job["group"]]
        records.append({"backend": dist.get_backend(), "world": mesh.world_size()})
    finally:
        mesh.shutdown(groups)
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{os.environ['RANK']}.json"), "w") as f:
        json.dump(records, f)
    return 0


def launch_ranks(root: str, tag: str, jobs: list, nproc: int, nccl: bool = False, deterministic: bool = False) -> list:
    """Run ``jobs`` in ``nproc`` rank processes of this script under torchrun;
    returns each rank's records.  A failed rank fails the run."""
    jobs_path, out = os.path.join(root, f"{tag}_jobs.json"), os.path.join(root, f"{tag}_ranks")
    os.makedirs(out, exist_ok=True)
    with open(jobs_path, "w") as f:
        json.dump(jobs, f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
           os.path.abspath(__file__), "--rank_worker", jobs_path, out, *(["--nccl"] if nccl else []),
           *(["--deterministic"] if deterministic else [])]
    env = {**os.environ, **({"CUBLAS_WORKSPACE_CONFIG": ":4096:8"} if deterministic else {})}
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=REPO, env=env)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        print(r.stdout[-6000:], file=sys.stderr)
        print(r.stderr[-10000:], file=sys.stderr)
    gate(r.returncode == 0, f"{tag}: torchrun of {nproc} rank(s) exited with {r.returncode}")
    ranks = []
    for i in range(nproc):
        with open(os.path.join(out, f"rank{i}.json")) as f:
            ranks.append(json.load(f))
    emit(f"{tag}_launch", ranks=nproc, wall_s=wall, backend=ranks[0][-1]["backend"], world=ranks[0][-1]["world"])
    return [r[:-1] for r in ranks]


def _job(name: str, cli: str, args: list, group: bool = True) -> dict:
    return {"name": name, "cli": cli, "args": [str(a) for a in args], "group": group}


def phase_ddp_train(root: str, lists: dict, card: str) -> tuple:
    """TAI_gray at the KTH configuration through the train CLI as rank
    processes: (a) one rank over NCCL, f32 B=2, 3 iterations in order,
    against the same run without a launch (bit-equal or rel 1e-6); (b) two
    ranks over gloo sharing cuda:0, f32 at local B=1 in order (each rank's
    strided shard makes the one-process B=2 batches), against the
    one-process run's terms (rel 1e-3); (c) two ranks in bf16
    (--device_normalize --sample_KTF, local B=4) for 20 iterations with
    snapshots and validation (15 clips, shards of 8 and 7) every 10, then a
    resume to 30.  Returns the launches of each rank's paths and the jobs of
    the two-rank launch (run with the predict jobs)."""
    c, d = TRAIN_CLI, DDP
    K, T, F = c["K"], c["T"], c["F"]
    in_order = ("--train_dtype", "float32", "--serial_batches", "--no_backwards", "--no_flip", "--num_threads", "0",
                "--print_freq", "1", "--save_latest_freq", "100", "--validate_freq", "100",
                "--max_iter", str(d["f32_iters"]))
    # (a) one rank over NCCL, and the reference: the same run without a
    # launch's group, first, in the same process.  Both take torch's
    # deterministic algorithms: without them two runs of this f32 program in
    # one process are not bit-equal after the first update on the H100, and
    # this gate asks for bit-equality or rel 1e-6.
    for name in ("ddp_ref", "ddp_nccl"):
        _start_snapshot(root, name)
    jobs = [_job(name, "train", _train_cli_args(root, name, lists, *in_order, "--batch_size", d["f32_batch"],
                                                base=KTH_FIXED_ARGS), group=name == "ddp_nccl")
            for name in ("ddp_ref", "ddp_nccl")]
    (ref_rec, nccl_rec), = launch_ranks(root, "ddp_train_nccl", jobs, 1, nccl=True, deterministic=True)
    ref = _events(root, "ddp_ref", "iter")
    gate(len(ref) == d["f32_iters"], f"ddp reference run logged {len(ref)} iterations")
    got = _events(root, "ddp_nccl", "iter")
    rels = [max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12) for k in TERM_NAMES) for g, w in zip(got, ref)]
    rel_nccl = max(rels)
    exact = all(g[k] == w[k] for g, w in zip(got, ref) for k in TERM_NAMES)

    # (b) two ranks in f32, (c) two ranks in bf16 and the resume: the jobs.
    _start_snapshot(root, "ddp_f32")
    val = {flag: _head(path, d["val_clips"], os.path.join(root, f"ddp{flag.replace('-', '_')}.txt"))
           for flag, path in lists.items() if flag != "--train_video_list_path"}
    lists15 = {"--train_video_list_path": lists["--train_video_list_path"], **val}
    bf16 = ("--train_dtype", "bfloat16", "--device_normalize", "--print_freq", "1", "--save_latest_freq", d["every"],
            "--validate_freq", d["every"], "--batch_size", d["batch"], "--device", "cuda:0")
    jobs = [_job("f32", "train", _train_cli_args(root, "ddp_f32", lists, *in_order, "--batch_size",
                                                 d["f32_batch"] // d["world"], "--device", "cuda:0",
                                                 base=KTH_FIXED_ARGS)),
            *(_job(f"bf16_{n}", "train", _train_cli_args(root, "ddp_bf16", lists15, *bf16, "--max_iter", n))
              for n in (d["iters"], d["resume_to"]))]
    emit("ddp_train_nccl", card=card, backend="nccl", ranks=1, dtype="float32", batch=d["f32_batch"],
         terms_max_rel_vs_one_process=rel_nccl, terms_max_rel_by_iter=rels, terms_bit_equal=exact,
         deterministic_algorithms=True, ms_per_it=nccl_rec["stats"]["ms_per_it"],
         ref_ms_per_it=ref_rec["stats"]["ms_per_it"], launches=nccl_rec["launches"],
         allreduce_bytes=sorted(set(nccl_rec["allreduce_bytes"])))
    _gate_launches("ddp_train one NCCL rank", nccl_rec["launches"], _f32_launches(nccl_rec["stats"]))
    _gate_launches("ddp_train reference", ref_rec["launches"], _f32_launches(ref_rec["stats"]))
    gate(len(got) == d["f32_iters"] and rel_nccl <= 1e-6,
         f"ddp_train one NCCL rank: terms off the run without a launch by rel {rel_nccl} > 1e-6")
    return {"ddp_train_nccl_rank0": nccl_rec["launches"]}, jobs, ref


def _f32_launches(stats: dict) -> dict:
    """The launches of an f32 run of ``DDP["f32_iters"]`` iterations without validation."""
    n = DDP["f32_iters"]
    return {"sepconv_fwd_mxu": 2 * (n + _cli_forwards(stats, n, 0)), "sepconv_bwd_vh": 2 * n, "sepconv_bwd_x": 2 * n}


def check_ddp_train(root: str, ranks: list, ref: list, card: str) -> dict:
    """The gates of ``phase_ddp_train``'s two-rank jobs (``ranks``: each rank's
    records in job order)."""
    c, d = TRAIN_CLI, DDP
    paths = {}
    # (b) f32: the ranks' mean terms against the one-process run at twice the batch.
    got = _events(root, "ddp_f32", "iter")
    rels = [max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12) for k in TERM_NAMES) for g, w in zip(got, ref)]
    rel = max(rels)
    f32 = [r[0] for r in ranks]
    for i, rec in enumerate(f32):
        paths[f"ddp_train_f32_rank{i}"] = rec["launches"]
        _gate_launches(f"ddp_train f32 rank {i}", rec["launches"], _f32_launches(rec["stats"]))
    emit("ddp_train_f32", card=card, backend="gloo", ranks=d["world"], device="cuda:0 (shared)", dtype="float32",
         local_batch=d["f32_batch"] // d["world"], iters=len(got), terms_max_rel_vs_one_process_B2=rel,
         terms_max_rel_by_iter=rels,
         digests_equal=len({r["digest"] for r in f32}) == 1, launches=[r["launches"] for r in f32],
         ms_per_it=[r["stats"]["ms_per_it"] for r in f32])
    gate(len(got) == d["f32_iters"] and rel <= 1e-3, f"ddp_train f32: two ranks' terms off one process by rel {rel}")
    gate(len({r["digest"] for r in f32}) == 1, "ddp_train f32: the ranks' states differ")

    # (c) bf16, 20 iterations and a resume to 30.
    iters = _events(root, "ddp_bf16", "iter")
    vals = _events(root, "ddp_bf16", "val")
    resumes = [e["iter"] for e in _events(root, "ddp_bf16", "resume")]
    finite = all(math.isfinite(e[k]) for e in iters for k in TERM_NAMES)
    runs = [[r[1], r[2]] for r in ranks]  # per rank: the first run, the resume
    ktf = [[k for rec in rr for k in rec["ktf"]] for rr in runs]
    digests = [[rec["digest"] for rec in rr] for rr in runs]
    starts = [[rec["stats"]["updates"] - rec["stats"]["iters"] for rec in rr] for rr in runs]
    saves = [[n for rec in rr for n in rec["saves"]] for rr in runs]
    tb = sorted(os.listdir(os.path.join(root, "tb", "ddp_bf16")))
    snapshots = sorted(os.listdir(os.path.join(root, "ckpt", "ddp_bf16")))
    g_bytes, d_bytes = runs[0][0]["allreduce_bytes"][:2]
    report = []
    for i, rr in enumerate(runs):
        launches = {k: sum(rec["launches"][k] for rec in rr) for k in COUNTED}
        paths[f"ddp_train_rank{i}"] = launches
        g_updates = sum(rec["stats"]["iters"] for rec in rr)
        mine = len(range(i, d["val_clips"], d["world"]))
        val_batches = sum(3 * len(rec["stats"]["val_s"]) * math.ceil(mine / d["batch"]) for rec in rr)
        vis = sum(_cli_forwards(rec["stats"], rec["stats"]["iters"], 3 * len(rec["stats"]["val_s"])) for rec in rr)
        want = {"sepconv_fwd_mxu": 2 * (g_updates + val_batches + vis), "sepconv_bwd_vh": 2 * g_updates,
                "sepconv_bwd_x": 2 * g_updates}
        report.append(dict(rank=i, launches=launches, want_launches=want, g_updates=g_updates, val_clips=mine,
                           val_batches=val_batches, visualisation_forwards=vis, starts=starts[i], saves=len(saves[i]),
                           tensorboard=[rec["stats"]["tensorboard"] for rec in rr],
                           ms_per_it=[float(np.median(rec["stats"]["ms_per_it"][1:])) for rec in rr]))
        _gate_launches(f"ddp_train rank {i}", launches, want)
    emit("ddp_train", card=card, backend="gloo", ranks=d["world"], device="cuda:0 (shared)", dtype="bfloat16",
         local_batch=d["batch"], global_batch=d["batch"] * d["world"], iters=len(iters), resumes=resumes,
         val_videos=[e["videos"] for e in vals], finite_terms=finite, same_KTF=ktf[0] == ktf[1],
         distinct_KTF=len({tuple(k) for k in ktf[0]}), digests_equal=[a == b for a, b in zip(*digests)],
         tensorboard_files=len(tb), snapshots=snapshots, grad_allreduce_bytes_G=g_bytes,
         grad_allreduce_bytes_D=d_bytes, per_rank=report)
    gate([e["iter"] for e in iters] == list(range(1, d["resume_to"] + 1)),
         f"ddp_train logged iterations {[e['iter'] for e in iters]} (one rank's log)")
    gate(finite, "ddp_train: non-finite loss terms")
    gate(ktf[0] == ktf[1] and len(ktf[0]) == d["resume_to"], "ddp_train: the ranks drew different (K, T, F)")
    gate(len({tuple(k) for k in ktf[0]}) > 1, "ddp_train: --sample_KTF sampled one (K, T, F)")
    gate(all(a == b for a, b in zip(*digests)), f"ddp_train: the ranks' final states differ: {digests}")
    gate(starts == [[0, d["iters"]]] * d["world"] and resumes == [d["iters"]],
         f"ddp_train: runs started at {starts}, resume events {resumes}")
    gate(saves[1] == [] and len(saves[0]) >= 6, f"ddp_train: snapshots saved per rank {saves}")
    gate(len(tb) == 2 * runs[0][0]["stats"]["tensorboard"] and not any(rec["stats"]["tensorboard"] for rec in runs[1]),
         f"ddp_train: TensorBoard files {tb}; rank 1 made a writer")
    gate(len(vals) == 9 and all(e["videos"] == d["val_clips"] for e in vals),
         f"ddp_train: validation rows {[e['videos'] for e in vals]}, want {d['val_clips']} each")
    gate({"model_latest.ckpt", f"model_{d['iters']:08d}.ckpt", f"model_{d['resume_to']:08d}.ckpt"} <= set(snapshots),
         f"ddp_train snapshots {snapshots}")
    shutil.rmtree(os.path.join(root, "ckpt", "ddp_bf16"))
    return paths


def ddp_predict_jobs(root: str, videolist: str) -> list:
    """The predict CLI's jobs for two ranks sharing cuda:0, on ``phase_predict``'s
    snapshot and clips."""
    cfg = PREDICT
    lst16 = os.path.join(root, "list16.txt")
    share = ("--device", "cuda:0")
    return [_job("bf16", "predict", _predict_args(cfg, root, videolist, os.path.join(root, "ddp_qual_bf16"),
                                                  "bfloat16", cfg["batch"], ["--device_normalize", *share])),
            _job("f32", "predict", _predict_args(cfg, root, lst16, os.path.join(root, "ddp_qual_f32"), "float32",
                                                 cfg["f32_batch"], share)),
            _job("int8", "predict", _predict_args(cfg, root, lst16, os.path.join(root, "ddp_qual_int8"), "bfloat16",
                                                  cfg["f32_batch"], ["--device_normalize", "--quantize", "int8",
                                                                     *share]))]


def check_ddp_predict(root: str, ranks: list, per_forward: int, card: str) -> dict:
    """The gates of the predict jobs of two ranks: the bf16 trees together are
    the one-process tree; f32 PNGs within 1 uint8 level of the one-process
    run's; int8: the same scales and gate verdict on both ranks, pred_middle
    at uint8 PSNR >= 45 dB of the one-process int8 run; launches per rank."""
    cfg, d = PREDICT, DDP
    K, T = cfg["K"], cfg["T"]
    paths, res = {}, {}
    bf16, f32, int8 = ([r[j] for r in ranks] for j in range(3))
    tree = _pngs(os.path.join(root, "ddp_qual_bf16"))
    want_tree = _pngs(os.path.join(root, "qual_bf16"))
    for mode, recs, clips, batch in (("bf16", bf16, cfg["clips"], cfg["batch"]),
                                     ("f32", f32, cfg["f32_clips"], cfg["f32_batch"])):
        for i, rec in enumerate(recs):
            mine = len(range(i, clips, d["world"]))
            batches = math.ceil(mine / batch)
            paths[f"ddp_predict_{mode}_rank{i}"] = rec["launches"]
            _gate_launches(f"ddp_predict {mode} rank {i}", rec["launches"], {"sepconv_fwd_mxu": 2 * batches})
            gate(rec["stats"]["clips"] == mine and f"[rank {i}] processed {mine}/{mine} clips" in rec["stdout"],
                 f"ddp_predict {mode} rank {i} predicted {rec['stats']['clips']} clips, want {mine}")
            pads = rec["stdout"].count(f"[rank {i}] padded final batch")
            gate(pads == (1 if mine % batch else 0), f"ddp_predict {mode} rank {i}: {pads} padding lines")
    gate(tree == want_tree, f"ddp_predict bf16: the ranks' trees hold {len(tree)} folders, one process "
                            f"{len(want_tree)}, or other files")
    gate(f"all {d['world']} ranks: {cfg['clips']} of {cfg['clips']} clips predicted" in bf16[0]["stdout"],
         "ddp_predict bf16: rank 0 printed no total")
    worst = 0
    for i in range(cfg["f32_clips"]):
        label = f"clip{i}.npy_1-{cfg['frames']}"
        for t in range(T):
            name = f"pred_middle_{K + t:04d}.png"
            a, b = (read_png(os.path.join(root, q, label, name)) for q in ("ddp_qual_f32", "qual_f32"))
            worst = max(worst, int(np.abs(a.astype(np.int16) - b).max()))
    gate(worst <= 1, f"ddp_predict f32: PNGs off the one-process run's by {worst} uint8 levels")

    digests = [re.findall(r"int8 activation scales sha256 (\w+)", rec["stdout"]) for rec in int8]
    verdicts = [re.findall(r"validate_quant verdict of rank 0: (\w+)", rec["stdout"]) for rec in int8]
    psnrs = []
    for i in range(cfg["f32_clips"]):
        label = f"clip{i}.npy_1-{cfg['frames']}"
        for t in range(T):
            name = f"pred_middle_{K + t:04d}.png"
            psnrs.append(u8_psnr(*(read_png(os.path.join(root, q, label, name))
                                   for q in ("ddp_qual_int8", "qual_predict_int8"))))
    for i, rec in enumerate(int8):
        paths[f"ddp_predict_int8_rank{i}"] = rec["launches"]
        cal = {"qconv_int8": per_forward, "sepconv_fwd_mxu": 2} if i == 0 else {}
        gate_q = {"qconv_int8": per_forward, "sepconv_fwd_mxu": 4} if i == 0 else {}
        want = {k: cal.get(k, 0) + gate_q.get(k, 0) + (per_forward if k in QKERNELS else 0) for k in COUNTED}
        want["sepconv_fwd_mxu"] += 2
        _gate_launches(f"ddp_predict int8 rank {i}", rec["launches"], want)
    res.update(f32_vs_one_process_max_levels=worst, int8_digests=digests, int8_verdicts=verdicts,
               int8_vs_one_process_u8_psnr_db_min=min(psnrs), folders=len(tree),
               clips_per_rank={m: [r["stats"]["clips"] for r in recs] for m, recs in
                               (("bf16", bf16), ("f32", f32), ("int8", int8))},
               loop_s_per_rank={m: [r["stats"]["loop_s"] for r in recs] for m, recs in
                                (("bf16", bf16), ("f32", f32), ("int8", int8))},
               launches=dict(paths))
    emit("ddp_predict", card=card, backend="gloo", ranks=d["world"], device="cuda:0 (shared)", **res)
    gate(len(set(sum(digests, []))) == 1 and all(len(x) == 1 for x in digests),
         f"ddp_predict int8: scale digests {digests}")
    gate(verdicts == [["passed"]] * d["world"], f"ddp_predict int8: gate verdicts {verdicts}")
    gate(min(psnrs) >= 45.0, f"ddp_predict int8: pred_middle at {min(psnrs)} dB of the one-process int8 run < 45")
    return paths


def phase_ddp(train_root: str, lists: dict, predict_root: str, videolist: str, per_forward: int, card: str) -> dict:
    """``ddp_train`` and ``ddp_predict``: one launch of one NCCL rank, one
    launch of two gloo ranks sharing cuda:0 for the train and predict jobs."""
    t0 = time.perf_counter()
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"ddp: compute mode {mode!r} (an exclusive mode refuses two ranks on one card)", flush=True)
    torch.cuda.empty_cache()
    paths, train_jobs, ref = phase_ddp_train(train_root, lists, card)
    torch.cuda.empty_cache()
    ranks = launch_ranks(train_root, "ddp", train_jobs + ddp_predict_jobs(predict_root, videolist), DDP["world"])
    paths.update(check_ddp_train(train_root, [r[:3] for r in ranks], ref, card))
    paths.update(check_ddp_predict(predict_root, [r[3:] for r in ranks], per_forward, card))
    emit("ddp", wall_s=time.perf_counter() - t0)
    return paths


# The model zoo: Super SloMo at the UCF-101 configuration and the SCT family at
# KTH's.  Neither runs sepconv: every zoo phase gates 0 launches of each kernel.
UCF_TEST_ARGS = ("@" + os.path.join(REPO, "exp_args", "default_args", "UCF-101", "test_5.txt"),
                 "@" + os.path.join(REPO, "exp_args", "extra_args", "UCF-101", "SuperSloMo_val_test.txt"))
UCF_TRAIN_ARGS = ("@" + os.path.join(REPO, "exp_args", "default_args", "UCF-101", "train.txt"),
                  "@" + os.path.join(REPO, "exp_args", "extra_args", "UCF-101", "SuperSloMo_train.txt"))
KTH_TRAIN_ARGS = ("@" + os.path.join(REPO, "exp_args", "default_args", "KTH", "train.txt"),)
# The predict CLI at UCF-101's test setting: 240x320 clips padded by 16 rows.
SLOMO_PREDICT = dict(model_key="SloMoFillInModel_color", name="ucf-101_SuperSloMo", param_seed=0, clip_seed=30,
                     clips=16, frames=13, H=240, W=320, pad=16, K=4, T=5, F=4, batch=16)
# The train CLI at UCF-101's train setting (160x192 crops of clips at that size).
SLOMO_TRAIN = dict(model_key="SloMoFillInModel_color", clip_seed=40, vgg_seed=14, H=160, W=192, K=4, T=3, F=4,
                   alt_T=5, alt_K=6, alt_F=6, train_clips=32, val_clips=8, batch=8, lr=1e-4, lr_decay_count=15,
                   lr_decay_rate=0.1)
UCF_FIXED_ARGS = (*(a for k in ("K", "T", "F", "alt_K", "alt_T", "alt_F") for a in (f"--{k}", str(SLOMO_TRAIN[k]))),
                  "--c_dim", "3", "--image_size", str(SLOMO_TRAIN["H"]), str(SLOMO_TRAIN["W"]),
                  "--model_key", SLOMO_TRAIN["model_key"])
# The train CLI at KTH's train setting with SCT Forward; the schedule takes the
# teacher-forcing rate from 0.99 at step 0 through 0.5 at 10 to 0.007 at 20.
SCT_TRAIN = dict(model_key="SCTSkipConScaledTForward_gray", param_seed=0, disc_seed=3, batch=8,
                 tf=("--tf_p_max", "1", "--tf_p_min", "0", "--tf_offset", "10", "--tf_decay", "2"))
SCT_TERM_NAMES = ("G_Lp", "G_gdl", "G_GAN", "G_loss", "D_fake", "D_real", "teacher_forced")
# The zoo's train CLI runs: bf16, uint8 normalised on the card, snapshots every
# 10 iterations, validation every 15.
ZOO_CLI_FLAGS = ("--train_dtype", "bfloat16", "--device_normalize", "--save_latest_freq", "10", "--validate_freq", "15")


def _zoo_launches(path: str) -> dict:
    """The launches since the last reset, gated at 0 for every kernel."""
    launches = _launch_counts()
    _gate_launches(path, launches, {})
    return launches


def _gate_golden(phase: str, run: str, report: dict, keys) -> None:
    gate(report["meta_ok"], f"{phase} {run}: the golden fixture does not match chip_smoke's configuration")
    for key in keys:
        err = report[f"{key}_max_abs"]
        gate(err <= 5e-3, f"{phase} {run}: {key} max_abs {err} > 5e-3 against the JAX golden")
    gate(report["pred_u8_psnr_db"] >= 45.0, f"{phase} {run}: uint8 PSNR {report['pred_u8_psnr_db']} dB < 45")


def phase_slomo_golden() -> dict:
    """SloMoFillInModel_color at 256x320, B=2, T=5, f32 (TF32 off), in both
    warp modes, against the JAX golden."""
    _reset_launch_counts()
    reports = check_slomo_golden(torch.device("cuda"))
    launches = _zoo_launches("slomo_golden")
    for mode, report in reports.items():
        emit("slomo_golden", model=SLOMO_GOLDEN["model_key"], warp_mode=mode, dtype="float32", tf32=False,
             batch=SLOMO_GOLDEN["B"], T=SLOMO_GOLDEN["T"], shape=[SLOMO_GOLDEN["H"], SLOMO_GOLDEN["W"], 3],
             launches=launches, **report)
        _gate_golden("slomo_golden", mode, report, SLOMO_KEYS)
    return launches


def phase_slomo_predict(root: str) -> dict:
    """SloMoFillInModel_color served by the predict CLI at UCF-101's test
    setting (the argfiles: K=4, T=5, F=4, 240x320 padded to 256x320, B=16) from
    a port snapshot of ``random_jax_params(..., 0)``, on 16 synthetic clips of
    13 frames, bf16 ``--device_normalize``: run twice (the first warms up),
    every PNG written, the metrics finite through ``compute_quant_results``."""
    c = SLOMO_PREDICT
    K, T, F = c["K"], c["T"], c["F"]
    videolist = make_videolist(os.path.join(root, "clips"), c["clips"], c["clip_seed"], n_frames=c["frames"],
                               hw=c["H"], width=c["W"])
    env = create_training_environment(create_model(c["model_key"]), TrainConfig(K=K, T=T, F=F, lambda_p=0.0))
    state = env.init_state((c["H"] + c["pad"], c["W"]), g_params=random_jax_params(c["model_key"], c["param_seed"]),
                           device="cpu")
    ckpt.save_snapshot(os.path.join(root, "ckpt", c["name"]), "model_best.ckpt", state,
                       {"updates": 0, "sum_avg_psnr_err": 0.0, "sum_avg_ssim_err": 0.0})
    del env, state
    runs = []
    for i in range(2):
        qual = os.path.join(root, f"qual{i}")
        _reset_launch_counts()
        stats, _ = run_predict([*UCF_TEST_ARGS, "--test_video_list_path", videolist, "--checkpoints_dir",
                                os.path.join(root, "ckpt"), "--qual_result_root", qual, "--dtype", "bfloat16",
                                "--device_normalize", "--device", "cuda"])
        launches = _zoo_launches("slomo_predict")
        runs.append((qual, stats))
    qual, stats = runs[-1]
    pngs = _pngs(qual)
    shape = read_png(os.path.join(qual, sorted(pngs)[0], f"pred_middle_{K:04d}.png")).shape
    gate(len(pngs) == c["clips"] and all(len(v) == K + 2 * T + F for v in pngs.values()),
         f"slomo_predict wrote {len(pngs)} folders of {sorted({len(v) for v in pngs.values()})} PNGs")
    gate(shape == (c["H"], c["W"], 3), f"slomo_predict PNGs of shape {shape}: the padding was not cropped off")
    quant = os.path.join(root, "quant")
    with contextlib.redirect_stdout(io.StringIO()):
        quant_cli.main([qual, quant, str(K), str(T)])
    z = np.load(os.path.join(quant, "results.npz"))
    finite = bool(np.isfinite(z["psnr"]).all() and np.isfinite(z["ssim"]).all())
    middles = stats["clips"] * T
    emit("slomo_predict", model=c["model_key"], args=list(UCF_TEST_ARGS), dtype="bfloat16", batch=c["batch"],
         device_normalize=True, clips=stats["clips"], batches=stats["batches"], folders=len(pngs), png_shape=shape,
         loop_s=stats["loop_s"], middle_frames_per_s=middles / stats["loop_s"], forward_s=stats["forward_s"],
         forward_only_middle_frames_per_s=middles / stats["forward_s"],
         forward_ms_per_batch=stats["forward_s"] / stats["batches"] * 1e3, write_s=stats["write_s"],
         warmup_loop_s=runs[0][1]["loop_s"], warmup_forward_s=runs[0][1]["forward_s"],
         quant_psnr_mean_db=float(z["psnr"].mean()), quant_ssim_mean=float(z["ssim"].mean()),
         quant_shape=list(z["psnr"].shape), finite_metrics=finite, launches=launches)
    gate(z["psnr"].shape == (c["clips"], T) and finite, f"slomo_predict metrics of shape {z['psnr'].shape}, "
                                                         f"finite {finite}")
    return launches


def _cli_ms_per_it(iters: list) -> dict:
    """Medians of a CLI run's per-iteration times (--print_freq 1), its first
    iteration left out: all of them, those at a (K, T, F) this process ran
    before, and those at a (K, T, F) it had not (whose shapes are new to
    cuDNN and the allocator)."""
    seen, ms = set(), {"repeat": [], "new": []}
    for e in iters:
        ktf = (e["K"], e["T"], e["F"])
        if e["iter"] > 1:
            ms["repeat" if ktf in seen else "new"].append(e["ms_per_it"])
        seen.add(ktf)
    med = {k: float(np.median(v)) if v else None for k, v in ms.items()}
    return {"ms_per_it": float(np.median([e["ms_per_it"] for e in iters[1:]])), "ms_per_it_repeat_KTF": med["repeat"],
            "ms_per_it_new_KTF": med["new"], "iters_new_KTF": len(ms["new"])}


def _zoo_cli_run(root: str, name: str, args_of, iters_total: int, resumes_want: list, terms: tuple) -> tuple:
    """A train CLI run of 20 iterations then a resume to 30: its launches,
    events and peak memory, gated: every iteration logged with finite terms,
    the resumes, 6 ``val`` events (at 15 and 30), the snapshots."""
    _reset_launch_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for n in (20, iters_total):
        run_train(args_of(name, "--max_iter", str(n)))
    peak = torch.cuda.max_memory_allocated()
    launches = _zoo_launches(name)
    iters = _events(root, name, "iter")
    vals = _events(root, name, "val")
    resumes = [e["iter"] for e in _events(root, name, "resume")]
    snapshots = sorted(os.listdir(os.path.join(root, "ckpt", name)))
    finite = all(math.isfinite(e[k]) for e in iters for k in terms)
    gate([e["iter"] for e in iters] == list(range(1, iters_total + 1)),
         f"{name}: logged iterations {[e['iter'] for e in iters]}")
    gate(finite, f"{name}: non-finite loss terms")
    gate(resumes == resumes_want, f"{name}: resume events at {resumes}, want {resumes_want}")
    gate(len(vals) == 6, f"{name}: {len(vals)} val events, want 6")
    gate({"model_latest.ckpt", "model_00000010.ckpt", "model_00000020.ckpt", "model_00000030.ckpt",
          "model_best.ckpt"} <= set(snapshots), f"{name} snapshots {snapshots}")
    return launches, iters, vals, resumes, snapshots, peak


def _f32_cli_vs_direct(root: str, name: str, args: list, env, start: str, ds, terms: tuple) -> dict:
    """The train CLI in f32 (TF32 off inside) at B=2 for 2 iterations, the
    data in order, against ``env.train_step`` on the same batches from the
    same start snapshot (the CLI's init batch is clips 0-1)."""
    _start_snapshot(root, name, start)
    _reset_launch_counts()
    _, stdout = run_train(args)
    launches = _zoo_launches(name)
    cli = _events(root, name, "iter")
    direct = []
    with uncounted():
        state, _ = ckpt.load_snapshot(os.path.join(root, start), "model_latest.ckpt",
                                      env.init_state(ds.image_size, device="cuda"))
        for first in (2, 4):
            batch = np.stack([ds[i]["targets"] for i in (first, first + 1)])
            state, m = env.train_step(state, env.cfg.K, env.cfg.T, env.cfg.F, batch)
            direct.append({k: float(v) for k, v in m.items()})
    rel = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12) for g, w in zip(cli, direct) for k in terms)
    report = dict(dtype="float32", batch=2, iters=len(cli), terms_max_rel_vs_train_step=rel,
                  tf32_off="TF32: matmul False, cudnn False" in stdout, launches=launches)
    gate(len(cli) == 2 and rel <= 1e-3, f"{name}: train CLI f32 terms off train_step by rel {rel} > 1e-3")
    gate(report["tf32_off"], f"{name}: the f32 train CLI did not run with TF32 off")
    return report


def phase_slomo_train_cli(root: str, vgg: str) -> dict:
    """SloMoFillInModel_color through the train CLI at UCF-101's train setting
    (the argfiles: 160x192, K=4, T=3, F=4, --sample_KTF; their videolists
    replaced by synthetic clips at 160x192: 32 training clips of 11 frames, 8
    for each validation set at 11, 13 and 15 frames) with the seeded VGG16
    .npz, bf16 --device_normalize, B=8, from a fresh init: 20 iterations
    (snapshots every 10, validation every 15), then a resume to 30; the rate
    of every update is the schedule's (--lr_decay_count 15).  Then the CLI in
    f32 at B=2 against ``SloMoEnvironment.train_step``."""
    c = SLOMO_TRAIN
    K, T, F = c["K"], c["T"], c["F"]

    def clips(name, n, frames, seed):
        return make_videolist(os.path.join(root, name), n, seed, n_frames=frames, hw=c["H"], width=c["W"])

    val = {"": clips("val", c["val_clips"], K + T + F, c["clip_seed"] + 1),
           "_alt_T": clips("val_alt_T", c["val_clips"], K + c["alt_T"] + F, c["clip_seed"] + 2),
           "_alt_K_F": clips("val_alt_K_F", c["val_clips"], c["alt_K"] + T + c["alt_F"], c["clip_seed"] + 3)}
    lists = {"--train_video_list_path": clips("train", c["train_clips"], K + T + F, c["clip_seed"]),
             **{f"--val_video_list{k}_path": v for k, v in val.items()},
             **{f"--vis_video_list{k}_path": v for k, v in val.items()}}

    def args_of(name, *extra, base=UCF_TRAIN_ARGS):
        return [*base, *(a for kv in lists.items() for a in kv), "--name", name, "--batch_size", str(c["batch"]),
                "--checkpoints_dir", os.path.join(root, "ckpt"), "--tensorboard_dir", os.path.join(root, "tb"),
                "--log_json", os.path.join(root, f"{name}.jsonl"), "--vgg16_weights", vgg,
                "--lr_decay_count", str(c["lr_decay_count"]), "--print_freq", "1", *extra]

    launches, iters, vals, resumes, snapshots, peak = _zoo_cli_run(
        root, "slomo", lambda name, *extra: args_of(name, *ZOO_CLI_FLAGS, *extra), 30, [20], SLOMO_TERM_NAMES)
    lr_want = [c["lr"] * c["lr_decay_rate"] ** ((e["iter"] - 1) // c["lr_decay_count"]) for e in iters]
    lr_ok = all(abs(e["lr"] - w) <= 1e-12 * w for e, w in zip(iters, lr_want))
    ktf = [(e["K"], e["T"], e["F"]) for e in iters]
    emit("slomo_train_cli", model=c["model_key"], args=list(UCF_TRAIN_ARGS), dtype="bfloat16", batch=c["batch"],
         iters=len(iters), resumes=resumes, val_events=[(e["iter"], e["tag"], e["psnr"], e["ssim"]) for e in vals],
         snapshots=snapshots, lr_after_resume=[e["lr"] for e in iters[20:22]], lr_matches_schedule=lr_ok,
         **_cli_ms_per_it(iters), mean_T=float(np.mean([k[1] for k in ktf])), distinct_KTF=len(set(ktf)),
         max_memory_allocated_bytes=peak, last_terms={k: iters[-1][k] for k in SLOMO_TERM_NAMES}, launches=launches)
    gate(lr_ok, f"slomo_train_cli rates {[e['lr'] for e in iters]} are not the schedule's {lr_want}")
    gate(len(set(ktf)) > 1, "slomo_train_cli: --sample_KTF sampled one (K, T, F)")
    shutil.rmtree(os.path.join(root, "ckpt", "slomo"))

    cfg = TrainConfig(K=K, T=T, F=F, vgg16_weights=vgg, lr_decay_count=c["lr_decay_count"])
    env = create_training_environment(create_model(c["model_key"]), cfg)
    ckpt.save_snapshot(os.path.join(root, "start"), "model_latest.ckpt", env.init_state((c["H"], c["W"]),
                                                                                        device="cpu"),
                       {"updates": 0, "sum_avg_psnr_err": 0.0, "sum_avg_ssim_err": 0.0})
    ds = ContiguousVideoClipDataset(3, lists["--train_video_list_path"], K + T + F, False, False, (c["H"], c["W"]),
                                    True)
    report = _f32_cli_vs_direct(root, "slomo_f32", args_of(
        "slomo_f32", "--batch_size", "2", "--train_dtype", "float32", "--serial_batches", "--no_backwards",
        "--no_flip", "--num_threads", "0", "--max_iter", "2", "--save_latest_freq", "100", "--validate_freq", "100",
        base=UCF_FIXED_ARGS), env, "start", ds, SLOMO_TERM_NAMES)
    emit("slomo_train_cli_f32", **report)
    return launches


def phase_slomo_train_golden(vgg_dir: str) -> dict:
    """Two f32 SloMoEnvironment steps at UCF-101's training width (B=1,
    160x192, T=3, the perceptual term on) against the JAX training golden."""
    _reset_launch_counts()
    report = check_slomo_train_golden(torch.device("cuda"), os.path.join(vgg_dir, "vgg16_golden.npz"))
    launches = _zoo_launches("slomo_train_golden")
    emit("slomo_train_golden", dtype="float32", tf32=False, batch=SLOMO_TRAIN_GOLDEN["B"], launches=launches,
         **report)
    gate(report["meta_ok"], "SloMo training golden fixture does not match SLOMO_TRAIN_GOLDEN")
    gate(report["terms_max_rel"] <= 1e-3, f"SloMo loss term {report['worst_term']} off the golden by rel "
                                          f"{report['terms_max_rel']} > 1e-3")
    gate(report["g_proj_rel"] <= 1e-3, f"SloMo gradient projections off the golden by {report['g_proj_rel']} > 1e-3")
    return launches


def phase_sct_golden(gen) -> dict:
    """The deterministic SCT variants (and Forward's teacher-forced pass) at
    KTH's width, f32, against the JAX golden; then RandomB in bf16 at B=8 from
    a seeded generator: finite, and the same seed gives the same frames."""
    _reset_launch_counts()
    reports = check_sct_golden(torch.device("cuda"))
    for run, report in reports.items():
        emit("sct_golden", run=run, model=SCT_GOLDEN_RUNS[run], dtype="float32", tf32=False, batch=SCT_GOLDEN["B"],
             **report)
        _gate_golden("sct_golden", run, report, ("pred",))
    key = "SCTSkipConScaledTRandomB_gray"
    ip = VideoInpainter(key, params_from_jax(random_jax_params(key, 0)), device="cuda", dtype=torch.bfloat16)
    p, f = (torch.rand(8, 5, 128, 128, 1, device="cuda", generator=gen).to(torch.bfloat16) * 2 - 1 for _ in range(2))
    with torch.inference_mode():
        a, b, other = (ip.model(5, p, f, generator=torch.Generator().manual_seed(s))["pred"] for s in (1, 1, 2))
    finite, same = bool(torch.isfinite(a).all()), bool(torch.equal(a, b))
    launches = _zoo_launches("sct_golden")
    emit("sct_random_order", model=key, dtype="bfloat16", batch=8, finite=finite, same_seed_bit_identical=same,
         other_seed_differs=not torch.equal(a, other), launches=launches)
    gate(finite and same, f"{key} bf16: finite {finite}, the same seed bit-identical {same}")
    return launches


def phase_sct_train_cli(root: str, lists: dict) -> dict:
    """SCT Forward through the train CLI at KTH's train setting (the KTH
    train argfile, its videolists replaced as ``train_cli``'s) with a teacher
    forcing schedule that falls from 0.99 to 0.007 over the run, bf16
    --device_normalize B=8, from a port snapshot at updates 0: 20 iterations,
    then a resume to 30, both branches in the events.  Then the CLI in f32 at
    B=2 against ``SCTEnvironment.train_step`` on the same batches."""
    c = SCT_TRAIN
    K, T, F = TRAIN_CLI["K"], TRAIN_CLI["T"], TRAIN_CLI["F"]
    cfg = TrainConfig(K=K, T=T, F=F, tf_p_max=1.0, tf_p_min=0.0, tf_offset=10.0, tf_decay=2.0)
    env = create_training_environment(create_model(c["model_key"]), cfg)
    hw = TRAIN_CLI["hw"]
    state = env.init_state((hw, hw), g_params=random_jax_params(c["model_key"], c["param_seed"]),
                           d_variables=random_jax_disc_variables(cfg, hw, hw, 1, c["disc_seed"]), device="cpu")
    ckpt.save_snapshot(os.path.join(root, "start_sct"), "model_latest.ckpt", state,
                       {"updates": 0, "sum_avg_psnr_err": 0.0, "sum_avg_ssim_err": 0.0})
    del state
    _start_snapshot(root, "sct", "start_sct")

    def args_of(name, *extra):
        return _train_cli_args(root, name, lists, "--model_key", c["model_key"], *c["tf"], "--print_freq", "1",
                               *ZOO_CLI_FLAGS, *extra, base=KTH_TRAIN_ARGS)

    launches, iters, vals, resumes, snapshots, peak = _zoo_cli_run(root, "sct", args_of, 30, [0, 20],
                                                                   SCT_TERM_NAMES)
    forced = [int(e["teacher_forced"]) for e in iters]
    emit("sct_train_cli", model=c["model_key"], args=list(KTH_TRAIN_ARGS), tf=list(c["tf"]), dtype="bfloat16",
         batch=c["batch"], iters=len(iters), resumes=resumes, teacher_forced=forced,
         val_events=[(e["iter"], e["tag"], e["psnr"], e["ssim"]) for e in vals], snapshots=snapshots,
         **_cli_ms_per_it(iters), max_memory_allocated_bytes=peak,
         last_terms={k: iters[-1][k] for k in SCT_TERM_NAMES}, launches=launches)
    gate(set(forced) == {0, 1}, f"sct_train_cli: teacher forcing took only {set(forced)}")
    shutil.rmtree(os.path.join(root, "ckpt", "sct"))

    ds = ContiguousVideoClipDataset(1, lists["--train_video_list_path"], K + T + F, False, False, (hw, hw), True)
    report = _f32_cli_vs_direct(root, "sct_f32", _train_cli_args(
        root, "sct_f32", lists, "--batch_size", "2", "--train_dtype", "float32", "--serial_batches", "--no_backwards",
        "--no_flip", "--num_threads", "0", "--max_iter", "2", "--print_freq", "1", "--save_latest_freq", "100",
        "--validate_freq", "100", "--model_key", c["model_key"], *c["tf"], base=KTH_FIXED_ARGS),
        env, "start_sct", ds, SCT_TERM_NAMES)
    emit("sct_train_cli_f32", **report)
    return launches


def phase_timing_zoo(gen, vgg: str) -> None:
    """CUDA-event times after a warm-up: ms per batch serving SloMo_color at
    256x320 (T=5; bf16 B=16, f32 B=2) and SCT Forward and RandomB at KTH
    (128x128, K=T=F=5, bf16 B=8); ms per training step of SloMo_color (B=8,
    160x192, K=4, T=3, F=4, the perceptual term on) and SCT Forward (B=8,
    KTH, free running) in bf16; peak device memory of each."""
    with uncounted():
        for key, dtype, B, (K, T, F, H, W, C) in (
                ("SloMoFillInModel_color", torch.bfloat16, 16, (4, 5, 4, 256, 320, 3)),
                ("SloMoFillInModel_color", torch.float32, 2, (4, 5, 4, 256, 320, 3)),
                ("SCTSkipConScaledTForward_gray", torch.bfloat16, 8, (5, 5, 5, 128, 128, 1)),
                ("SCTSkipConScaledTRandomB_gray", torch.bfloat16, 8, (5, 5, 5, 128, 128, 1))):
            ip = VideoInpainter(key, params_from_jax(random_jax_params(key, 0)), device="cuda", dtype=dtype)
            p = torch.rand(B, K, H, W, C, device="cuda", generator=gen).to(dtype) * 2 - 1
            f = torch.rand(B, F, H, W, C, device="cuda", generator=gen).to(dtype) * 2 - 1
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: ip.forward(T, p, f), iters=5)
            emit("timing_zoo", kind="serve", model=key, dtype=str(dtype), batch=B, K=K, T=T, F=F, shape=[H, W, C],
                 tf32=False, ms_per_batch=ms, middle_frames_per_s=B * T / (ms / 1e3),
                 max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
            del ip, p, f
            torch.cuda.empty_cache()
        for key, B, (K, T, F, H, W, C), cfg in (
                ("SloMoFillInModel_color", 8, (4, 3, 4, 160, 192, 3), dict(vgg16_weights=vgg)),
                ("SCTSkipConScaledTForward_gray", 8, (5, 5, 5, 128, 128, 1), {})):
            env = create_training_environment(create_model(key), TrainConfig(K=K, T=T, F=F, train_dtype="bfloat16",
                                                                              **cfg))
            state = env.init_state((H, W), device="cuda")
            targets = torch.rand(B, K + T + F, H, W, C, device="cuda", generator=gen) * 2 - 1
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: env.train_step(state, K, T, F, targets), iters=5)
            emit("timing_zoo", kind="train_step", model=key, dtype="bfloat16", batch=B, K=K, T=T, F=F,
                 shape=[H, W, C], ms_per_step=ms, steps_per_s=1e3 / ms,
                 max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
            del env, state, targets
            torch.cuda.empty_cache()


# int8 serving of the zoo through the predict CLI (--quantize int8 and
# int8_dynamic; bf16 --device_normalize): SloMo_color at its golden
# configuration and SCT Forward at KTH's, each from a snapshot of
# random_jax_params(key, 0); timed at PERF.md's serving batches.
ZOO_INT8 = {
    "slomo": dict(model_key=SLOMO_GOLDEN["model_key"], **{k: SLOMO_GOLDEN[k] for k in ("K", "T", "F", "H", "W", "C")},
                  clip_seed=50, clips=4, batch=4, time_batch=16),
    "sct": dict(model_key=SCT_GOLDEN_RUNS["forward"], **{k: SCT_GOLDEN[k] for k in ("K", "T", "F", "H", "W", "C")},
                clip_seed=51, clips=4, batch=4, time_batch=8),
}


@contextlib.contextmanager
def qconv_call_checks(plain: dict):
    """Every ``QConv`` call made inside, held against its recomputation by
    ``plain``'s functions (:func:`qconv_plain`, after the call: a
    calibrating call's updated amax): yields {"calls": n, "max_ulps": the worst |y -
    plain| in ulps of the output's dtype}."""
    forward = quant.QConv.forward
    rec = {"calls": 0, "max_ulps": 0.0}

    def checked(self, x):
        y = forward(self, x)
        want = qconv_plain(self, x, plain).float()
        ulp = bf16_ulp(want) if x.dtype == torch.bfloat16 else f32_ulp(want)
        rec["calls"] += 1
        rec["max_ulps"] = max(rec["max_ulps"], float(((y.float() - want).abs() / ulp).max()))
        return y

    quant.QConv.forward = checked
    try:
        yield rec
    finally:
        quant.QConv.forward = forward


def phase_zoo_int8(root: str, gen) -> dict:
    """SloMo_color (256x320, K=F=4, T=5) and SCT Forward (gray 128x128,
    K=T=F=5) served by ``cli.predict`` from a snapshot of seeded full-width
    weights, bf16 ``--device_normalize`` at B=4 on 4 synthetic clips, under
    ``--quantize int8`` (calibrated on those clips) and ``int8_dynamic``,
    with the default ``--validate_quant`` gate (4 clips against the float
    model of the same weights in f32): every int8 conv call of calibration,
    gate and loop equal to its plain recomputation (0 ulps), one
    ``qconv_int8`` launch per call and the same count in every forward, no
    plain call, no sepconv launch, every PNG written.  Then the int8 forwards
    (static calibrated on the batch, dynamic) timed in turns with the float
    bf16 forward at B=16 (SloMo) and B=8 (SCT).  Returns each run's launches."""
    t_phase = time.perf_counter()
    paths = {}
    for name, c in ZOO_INT8.items():
        K, T, F, H, W, C = (c[k] for k in ("K", "T", "F", "H", "W", "C"))
        work = os.path.join(root, name)
        videolist = make_videolist(os.path.join(work, "clips"), c["clips"], c["clip_seed"], n_frames=K + T + F,
                                   hw=H, width=W)
        params = params_from_jax(random_jax_params(c["model_key"], 0))
        ckpt.write_payload(os.path.join(work, "ckpt", name), "model_best.ckpt",
                           {"generator": params, "counters": {"updates": 0, "sum_avg_psnr_err": 0.0,
                                                              "sum_avg_ssim_err": 0.0}})
        for mode in ("int8", "int8_dynamic"):
            qual = os.path.join(work, f"qual_{mode}")
            stages = {}
            _reset_launch_counts()
            t0 = time.perf_counter()
            with plain_calls() as (plain, originals), qconv_call_checks(originals) as rec, stage_launches(stages):
                stats, stdout = run_predict([
                    "--K", str(K), "--T", str(T), "--F", str(F), "--c_dim", str(C), "--image_size", str(H), str(W),
                    "--batch_size", str(c["batch"]), "--dtype", "bfloat16", "--model_key", c["model_key"],
                    "--name", name, "--checkpoints_dir", os.path.join(work, "ckpt"), "--test_video_list_path",
                    videolist, "--qual_result_root", qual, "--device", "cuda", "--device_normalize",
                    "--quantize", mode])
            wall = time.perf_counter() - t0
            path = f"zoo_int8_{name}_{mode}"
            paths[path] = launches = _launch_counts()
            per_forward = stages["gate"]["qconv_int8"]
            forwards = -(-c["clips"] // c["batch"]) + (2 if mode == "int8" else 1)
            pngs = _pngs(qual)
            verdict = VALIDATE_LINE.search(stdout)
            emit("zoo_int8", model=c["model_key"], quantize=mode, dtype="bfloat16", batch=c["batch"],
                 shape=[H, W, C], K=K, T=T, F=F, calls=rec["calls"], calls_vs_plain_max_ulps=rec["max_ulps"],
                 per_forward=per_forward, forwards=forwards, stage_launches=stages, plain_calls=plain,
                 validate_psnr_f32_db=verdict and float(verdict[1]), validate_psnr_int8_db=verdict and float(verdict[2]),
                 validate_agreement_db=verdict and float(verdict[3]), loop_s=stats["loop_s"], wall_s=wall, **launches)
            gate(rec["calls"] > 0 and rec["max_ulps"] == 0.0,
                 f"{path}: an int8 conv call {rec['max_ulps']} ulps off its plain recomputation ({rec['calls']} calls)")
            gate(not any(plain.values()), f"{path}: a plain version ran: {plain}")
            _gate_launches(path, launches, {"qconv_int8": rec["calls"]})
            gate(rec["calls"] == per_forward * forwards and stages.get("calibration", {}).get("qconv_int8", 0) == (
                per_forward if mode == "int8" else 0), f"{path}: {rec['calls']} calls, stages {stages}")
            gate(verdict is not None and "REFUSED" not in stdout,
                 f"{path}: no validate_quant line, or REFUSED: {[ln for ln in stdout.splitlines() if 'quant' in ln]}")
            gate(len(pngs) == c["clips"] and all(len(v) == K + 2 * T + F for v in pngs.values()),
                 f"{path} wrote {len(pngs)} folders of {sorted({len(v) for v in pngs.values()})} PNGs")
            torch.cuda.empty_cache()

        # The int8 forwards beside the float one, bf16, in turns.
        B = c["time_batch"]
        p = (torch.rand(B, K, H, W, C, device="cuda", generator=gen) * 2 - 1).bfloat16()
        f = (torch.rand(B, F, H, W, C, device="cuda", generator=gen) * 2 - 1).bfloat16()
        ips = {"float": VideoInpainter(c["model_key"], params, device="cuda", dtype=torch.bfloat16),
               "static": int8_inpainter(c["model_key"], params, "2", torch.bfloat16),
               "dynamic": int8_inpainter(c["model_key"], params, "1", torch.bfloat16)}
        with uncounted():
            with quant.calibrate(ips["static"].model), torch.inference_mode():
                ips["static"].model(T, p, f)
            times = _time_in_turns({mode: (lambda ip=ip: ip.forward(T, p, f)) for mode, ip in ips.items()})
        for mode, (ms, mem) in times.items():
            emit("timing_zoo_int8", model=c["model_key"], dtype="bfloat16", mode=mode, batch=B, shape=[H, W, C],
                 ms_per_batch=ms, middle_frames_per_s=B * T / (ms / 1e3), max_memory_allocated_bytes=mem,
                 vs_float=times["float"][0] / ms)
        del ips, p, f
        torch.cuda.empty_cache()
    emit("zoo_int8_phase", wall_s=time.perf_counter() - t_phase)
    return paths


def run_zoo(root: str, gen) -> dict:
    """Every zoo phase in ``root``; returns each path's launches (all 0 but
    ``zoo_int8``'s int8 conv launches)."""
    os.makedirs(root, exist_ok=True)
    vgg = random_vgg16_npz(os.path.join(root, "vgg16.npz"), SLOMO_TRAIN["vgg_seed"])
    paths = {"slomo_golden": phase_slomo_golden()}
    torch.cuda.empty_cache()
    paths["slomo_predict"] = phase_slomo_predict(os.path.join(root, "predict"))
    torch.cuda.empty_cache()
    paths["slomo_train_cli"] = phase_slomo_train_cli(os.path.join(root, "slomo_train"), vgg)
    torch.cuda.empty_cache()
    paths["slomo_train_golden"] = phase_slomo_train_golden(root)
    torch.cuda.empty_cache()
    paths["sct_golden"] = phase_sct_golden(gen)
    torch.cuda.empty_cache()
    sct_root = os.path.join(root, "sct_train")
    paths["sct_train_cli"] = phase_sct_train_cli(sct_root, _train_cli_lists(sct_root))
    torch.cuda.empty_cache()
    paths.update(phase_zoo_int8(os.path.join(root, "int8"), gen))
    torch.cuda.empty_cache()
    phase_timing_zoo(gen, vgg)
    return paths


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


def phase_timing(state, peak, main_err: dict, adj_err: dict, path_launches: dict, gen, qconv: dict, baseline=None):
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
    # The int8 kernel: no TPU kernel (vfi_tpu left the int8 conv and its
    # quantize to XLA); timed at QCONV_HEADLINE, with the sums over one B=64
    # TAI_gray forward.
    h, t = qconv["headline"], qconv["totals"]
    total, by_path = launches("qconv_int8")
    kernels.append({
        "name": "qconv_int8", "route": "cuda", "source": "vfi_tpu_torch/ops/csrc/qconv_int8.cu",
        "replaces": "vfi_tpu/nn/quant.py:110", "replaces_what": "XLA's activation quantize, int8 conv and dequantize "
        "(vfi_tpu/nn/quant.py:110-123; no Pallas kernel)", "launches": total, "launches_by_path": by_path,
        "max_abs_err": h["max_abs_err"], "ms": h["ms"], "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
        "bound_by": h["bound_by"], "library_ms": h["library_ms"],
        "library": "torch._int_mm on the implicit GEMM's operands: GEMM alone, im2col not counted",
        "cudnn_bf16_ms": h["cudnn_bf16_ms"], "shape": h["shape"], "images": h["images"],
        "dtype": "bfloat16 in, bfloat16 out", **{f"{k}_per_forward": v for k, v in t.items()},
        **({} if "baseline_ms" not in h else {"baseline_ms": h["baseline_ms"],
                                              "baseline_bound_ms": h["baseline_bound_ms"]}),
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
    qconv = baseline_qconv(checkout, out_dir)

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
            "sepconv_bwd_x": bwd_x, **({} if qconv is None else {"qconv_int8": qconv})}


def baseline_qconv(checkout: str, out_dir: str):
    """The int8 kernels of another checkout whose ``ops/csrc/qconv_int8.cu``
    has the unfused int8 version's two C entries (a quantize pass to NHWC int8,
    then the conv on it), built into ``out_dir`` and wrapped as (x bfloat16,
    x_scale, wq, scale, bias) -> y bfloat16; None for a checkout without
    them."""
    import ctypes

    src = os.path.join(checkout, "vfi_tpu_torch", "ops", "csrc", "qconv_int8.cu")
    if not os.path.exists(src) or 'extern "C" int quantize_int8(' not in open(src).read():
        return None
    so = os.path.join(out_dir, "libqconv_int8_baseline.so")
    proc = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", so, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"chip_smoke: {src} failed to build:\n{proc.stdout + proc.stderr}")
    lib = ctypes.CDLL(so)
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.quantize_int8.argtypes = [P] * 3 + [I64] * 4 + [I] * 6 + [P]
    lib.qconv_int8.argtypes = [P] * 5 + [I] * 7 + [P]

    def run(x, x_scale, wq, scale, bias):
        N, C, H, W = x.shape
        Co, k, _, Cp = wq.shape
        xq = torch.empty((N, H, W, Cp), dtype=torch.int8, device=x.device)
        y = torch.empty((N, Co, H, W), dtype=torch.bfloat16, device=x.device)
        st = torch.cuda.current_stream().cuda_stream
        rc = lib.quantize_int8(x.data_ptr(), x_scale.data_ptr(), xq.data_ptr(), *x.stride(), N, C, H, W, Cp, 1, st)
        rc = rc or lib.qconv_int8(xq.data_ptr(), wq.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), N, H,
                                  W, Cp, Co, k, 2, st)
        if rc != 0:
            raise SystemExit(f"chip_smoke: the baseline's int8 kernels failed: CUDA error {rc}")
        return y

    return run


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
                    help="another checkout of this repo (an earlier commit): time its four sepconv kernels, "
                         "and its int8 quantize + conv where it has the unfused quantize_int8 and qconv_int8 entries, "
                         "in turns with these, "
                         "as baseline_* keys of the timing_kernel, timing_qconv and kernels lines")
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
    gate(sorted(_kernels.SOURCES) == sorted(KERNELS + QKERNELS),
         f"built {sorted(_kernels.SOURCES)}, the paths run {KERNELS + QKERNELS}")
    spills = {n: [ln for ln in lines if re.search(r"[1-9]\d* bytes spill (stores|loads)", ln)]
              for n, lines in ptxas.items()}
    gate(not any(spills.values()), f"ptxas reports spills: {spills}")
    cuobjdump = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_kernels.library_path("qconv_int8"))], capture_output=True,
                          text=True, timeout=600).stdout
    gmma = sorted({ln.split()[1] for ln in sass.splitlines() if "GMMA" in ln and len(ln.split()) > 1})
    emit("qconv_sass", warpgroup_mma=gmma, lines=sum("GMMA" in ln for ln in sass.splitlines()))
    gate(any(op.startswith("IGMMA") for op in gmma), "qconv_int8's SASS holds no int8 warpgroup MMA (IGMMA)")
    baseline = baseline_kernels(os.path.abspath(args.baseline)) if args.baseline else None

    gen = torch.Generator(device="cuda").manual_seed(0)
    main_err = phase_kernel_checks(gen)
    adj_err = phase_adjoint_checks(gen)
    state = params_from_jax(random_jax_params(GOLDEN["model_key"], GOLDEN["param_seed"]))
    paths = {"serve": phase_serve(state), "serve_pallas": phase_serve(state, "pallas"),
             "serve_color": phase_serve_color()}
    schedule = int8_schedule(state)
    qconv_numbers = phase_qconv_kernel(gen, peak, schedule, baseline)
    paths.update(phase_serve_int8(state, gen))
    # The predict phases' snapshot, clips and trees stay for the ddp phases.
    predict_root = os.path.join(str(_kernels.BUILD_DIR), "predict_smoke")
    train_cli_root = os.path.join(str(_kernels.BUILD_DIR), "train_cli_smoke")
    for root in (predict_root, train_cli_root):
        shutil.rmtree(root, ignore_errors=True)
    try:
        predict_paths, (videolist, warm) = phase_predict(predict_root)
        paths.update(predict_paths)
        phase_timing_predict(predict_root, videolist, warm)
        paths.update(phase_predict_int8(predict_root, videolist, len(schedule)))
        paths.update(phase_reference_import(predict_root, videolist, smi[0] if smi else ""))
        paths.update(phase_figures(predict_root, videolist, len(schedule), smi[0] if smi else ""))
        torch.cuda.empty_cache()
        env, tstate, targets = phase_train_golden()
        phase_train_kernel_vs_plain(env, tstate, targets)
        del env, tstate, targets
        torch.cuda.empty_cache()
        paths["train_pallas"] = phase_train_pallas()
        torch.cuda.empty_cache()
        paths["train"], train_ms = phase_train(gen)
        paths["train_color"] = phase_train_color(gen)
        lists = _train_cli_lists(train_cli_root)
        paths.update(phase_train_cli(train_cli_root, lists))
        phase_timing_train_cli(train_cli_root, lists, train_ms)
        paths.update(phase_ddp(train_cli_root, lists, predict_root, videolist, len(schedule), smi[0] if smi else ""))
    finally:
        for root in (predict_root, train_cli_root):
            shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    zoo_root = os.path.join(str(_kernels.BUILD_DIR), "zoo_smoke")
    shutil.rmtree(zoo_root, ignore_errors=True)
    t_zoo = time.perf_counter()
    try:
        paths.update(run_zoo(zoo_root, gen))
    finally:
        shutil.rmtree(zoo_root, ignore_errors=True)
    emit("zoo", wall_s=time.perf_counter() - t_zoo)
    torch.cuda.empty_cache()
    phase_timing(state, peak, main_err, adj_err, paths, gen, qconv_numbers, baseline)

    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank_worker"]:
        sys.exit(rank_worker(sys.argv[2:]))
    sys.exit(main(sys.argv[1:]))

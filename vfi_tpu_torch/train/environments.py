"""Evaluation and GAN training environments (counterpart of
``vfi_tpu/train/environments.py``).

    env = create_eval_environment(model, TrainConfig(K=5, T=5, F=5))
    out = env.forward_test(T, preceding, following)   # the model's outputs, no autograd
    m = env.eval_metrics(K, T, F, targets)             # psnr / ssim / l2 per [B, T]

    env = create_training_environment(model, TrainConfig(K=5, T=5, F=5))
    state = env.init_state((H, W))                    # on cuda
    state, terms = env.train_step(state, K, T, F, targets)

``targets`` are videos ``[B, K+T+F, H, W, C]`` in [-1, 1].  One step is one
generator update then one discriminator update, as in vfi_tpu: the D update
scores the generator's prediction from *before* its update, detached, and
runs no second forward.  Unlike vfi_tpu's pure steps, ``train_step`` updates
the state's modules and optimizers in place (no second copy of the weights
or Adam moments) and returns the same state.

Data parallelism (``create_training_environment(model, cfg, group)``): each
rank steps on its own rows, and every update averages its gradients over the
group's ranks before Adam steps, so ranks that start from the same state
(``parallel.replicate_state``) stay bit-identical and each update is the
update on the global batch.

SCT models train in :class:`SCTEnvironment` (teacher forcing on a sigmoid
schedule, random generation orders drawn from the state's ``rng``), Super
SloMo in ``slomo_env.SloMoEnvironment`` (no discriminator; its state's
``discriminator`` and ``d_opt`` are None).

Mixed precision (``cfg.train_dtype == "bfloat16"``) is vfi_tpu's explicit
cast, not autocast: each network runs on bf16 copies of its f32 master
parameters (``torch.func.functional_call``), so gradients arrive in f32 and
the master weights and Adam state stay f32.  The generator's inputs are cast
and its outputs cast back to f32 before the losses; in the G step the
discriminator runs in f32 on the f32 prediction beside the bf16-rounded
context frames; in the D step its parameters and all videos are bf16, while
``u`` and the power iteration stay f32.
"""

from __future__ import annotations

import copy
import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from ..api import resolve_device
from ..models.fill_in import (BidirectionalSimpleAverageFillInModel, BidirectionalTimeWeightedAverageFillInModel,
                              MCNetFillInModel, TAIFillInModel)
from ..models.sct import BaseSCTFillInModel
from ..models.slomo import SloMoFillInModel
from ..nn.discriminator import SNDiscriminator
from ..ops.image import inverse_transform
from ..ops.metrics import psnr, quantize_uint8, ssim
from ..parallel.mesh import allreduce_mean_
from ..utils.params import disc_variables_from_jax, params_from_jax
from .losses import bce_with_logits, disc_window_labels, gdl_loss, l2_loss

Terms = Dict[str, torch.Tensor]


@dataclass
class TrainState:
    """The generator, the discriminator (its ``u`` buffers are vfi_tpu's
    ``d_sn``; None for a model trained without one), their Adam optimizers,
    the number of steps taken, and the generator of the environment's random
    draws (a CPU ``torch.Generator``, or None where it draws nothing)."""

    generator: nn.Module
    discriminator: Optional[SNDiscriminator]
    g_opt: torch.optim.Adam
    d_opt: Optional[torch.optim.Adam]
    step: int = 0
    rng: Optional[torch.Generator] = None

    @property
    def device(self) -> torch.device:
        return next(self.generator.parameters()).device


def split_batch(targets: torch.Tensor, K: int, T: int, F: int):
    """targets [B, K+T+F, H, W, C] -> (preceding, middle, following)."""
    return targets[:, :K], targets[:, K : K + T], targets[:, K + T : K + T + F]


def _set_grads(module: nn.Module, loss: torch.Tensor, group=None) -> None:
    """``.grad`` of every parameter of ``module`` (zeros where unused); no
    other parameter's gradient is computed or touched.  With a process
    ``group``, the gradients are averaged over its ranks first (one
    all-reduce), so each rank's update is the update on the global batch:
    the all-reduce XLA inserts for vfi_tpu's data-sharded batch.  The steps
    take gradients with ``torch.autograd.grad``, not ``.backward()``, so
    ``DistributedDataParallel``'s hooks would never fire."""
    params = list(module.parameters())
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, torch.autograd.grad(loss, params, allow_unused=True))]
    if group is not None:
        allreduce_mean_(grads, group)
    for p, g in zip(params, grads):
        p.grad = g


def mean_terms(terms: Terms, group=None) -> Dict[str, float]:
    """A step's terms as floats (waits for the device), averaged over the
    ranks of ``group`` where one is given: with equal local batches, the
    means over the global batch that vfi_tpu prints.  Every rank of the
    group must call it."""
    keys = sorted(terms)
    values = torch.stack([terms[k].float() for k in keys])
    if group is not None:
        allreduce_mean_([values], group)
    return dict(zip(keys, values.tolist()))


class BaseEnvironment:
    """Shared: the generator's evaluation; subclasses add losses and optimizers.

    ``forward_test`` and ``eval_metrics`` run the environment's model as it
    stands (its weights and dtype) on the inputs' device; a model without
    parameters (``TimeWeightedPFFillInModel``) works the same way."""

    needs_snapshot = True  # False for parameter-free models

    def __init__(self, model: nn.Module, cfg, group=None):
        self.model = model
        self.cfg = cfg
        self.group = group  # the process group gradients are averaged over; None in one process

    def _adam(self, module: nn.Module) -> torch.optim.Adam:
        return torch.optim.Adam(module.parameters(), lr=self.cfg.lr, betas=(self.cfg.beta1, 0.999), eps=1e-8)

    # -- mixed precision ------------------------------------------------------
    def _compute_cast(self, tensors):
        """bf16 copies of the float32 tensors (a dict or a tuple) when
        ``cfg.train_dtype == "bfloat16"``; the same tensors otherwise.  The
        cast is differentiable, so gradients reach the f32 masters."""
        if self.cfg.train_dtype != "bfloat16":
            return tensors

        def cast(a):
            return a.to(torch.bfloat16) if a.dtype == torch.float32 else a

        if isinstance(tensors, dict):
            return {k: cast(a) for k, a in tensors.items()}
        return tuple(cast(a) for a in tensors)

    def _cast_params(self, module: nn.Module) -> Dict[str, torch.Tensor]:
        return self._compute_cast(dict(module.named_parameters()))

    @torch.inference_mode()
    def forward_test(self, T: int, preceding: torch.Tensor, following: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.model(T, preceding, following)

    @torch.inference_mode()
    def eval_metrics(self, K: int, T: int, F: int, targets, device=None) -> Dict[str, torch.Tensor]:
        """Per-(video, timestep) PSNR/SSIM/L2 ``[B, T]`` of a batch of videos
        ``[B, K+T+F, H, W, C]`` in [-1, 1], scored in float32.  The model
        takes a tensor's frames in their dtype on their device, an array's in
        float32 on ``device`` (default: the CPU)."""
        if not torch.is_tensor(targets):
            targets = torch.as_tensor(targets, dtype=torch.float32, device=device)
        p, m, f = split_batch(targets, K, T, F)
        pred = self.model(T, p, f)["pred"].float()
        m = m.float()
        pred_u8, gt_u8 = quantize_uint8(pred), quantize_uint8(m)
        return {
            "psnr": psnr(pred_u8, gt_u8, clamp=100.0),
            "ssim": ssim(pred_u8, gt_u8),
            "l2": torch.mean((inverse_transform(pred) - inverse_transform(m)) ** 2, dim=(2, 3, 4)),
        }


class L2GDLDiscEnvironment(BaseEnvironment):
    """MSE + GDL + sliding-window SN-GAN training."""

    min_K = 1
    min_F = 1

    # -- init ---------------------------------------------------------------
    def init_state(self, image_size: Tuple[int, int], *, g_params=None, d_variables=None, device=None,
                   seed: int = 0) -> TrainState:
        """A fresh state for frames of ``image_size`` (H, W).

        :param g_params: vfi_tpu generator ``params`` (flax layout); default:
            a copy of the environment's model as it stands
        :param d_variables: vfi_tpu discriminator ``{"params", "sn"}``;
            default: the port's own init, drawn under ``seed``
        :param device: ``cuda`` unless ``"cpu"`` is asked for
        """
        dev = resolve_device(device)
        c = self.cfg
        generator = copy.deepcopy(self.model)
        if g_params is not None:
            generator.load_state_dict(params_from_jax(g_params))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            discriminator = SNDiscriminator(c.disc_window_size, generator.c_dim, image_size, c.df_dim, c.Ip)
        if d_variables is not None:
            discriminator.load_state_dict(disc_variables_from_jax(d_variables))
        generator.to(dev).train()
        discriminator.to(dev).train()
        return TrainState(generator, discriminator, self._adam(generator), self._adam(discriminator))

    # -- generator loss ------------------------------------------------------
    def _recon_terms(self, out, gt_middle) -> Terms:
        pred01 = inverse_transform(out["pred"])
        gt01 = inverse_transform(gt_middle)
        return {"G_Lp": l2_loss(pred01, gt01), "G_gdl": gdl_loss(pred01, gt01)}

    def _extra_recon_terms(self, out, gt_middle) -> Terms:
        return {}

    def _g_loss(self, state: TrainState, K: int, T: int, F: int, targets: torch.Tensor):
        """(loss, (outputs, terms)); the discriminator runs with ``train=False``."""
        p, m, f = split_batch(targets, K, T, F)
        p, f = self._compute_cast((p, f))
        out = self._g_forward(state, T, p, m, f)
        out = {k: a.float() for k, a in out.items()}
        terms = self._recon_terms(out, m)
        extra = self._extra_recon_terms(out, m)

        fake_video = torch.cat([p.float(), out["pred"], f.float()], dim=1)
        logits = state.discriminator(fake_video, train=False)
        terms["G_GAN"] = bce_with_logits(logits, torch.ones_like(logits))

        c = self.cfg
        loss = c.alpha * (terms["G_Lp"] + terms["G_gdl"] + sum(extra.values())) + c.beta * terms["G_GAN"]
        terms.update(extra)
        terms["G_loss"] = loss
        return loss, (out, terms)

    def _g_forward(self, state: TrainState, T: int, p, m, f) -> Dict[str, torch.Tensor]:
        """The generator on its compute-dtype parameters (``m``, the ground
        truth middle frames in float32, is there for teacher forcing)."""
        return functional_call(state.generator, self._cast_params(state.generator), (T, p, f))

    # -- discriminator loss --------------------------------------------------
    def _d_loss(self, state: TrainState, pred: torch.Tensor, K: int, T: int, F: int, targets: torch.Tensor):
        """(loss, terms).  Writes the SN state: fake scores with u0 and writes
        u1, real scores with u1 and writes u2."""
        disc = state.discriminator
        params = self._cast_params(disc)
        p, m, f = split_batch(targets, K, T, F)
        p, m, f, pred = self._compute_cast((p, m, f, pred.detach()))
        fake_video = torch.cat([p, pred, f], dim=1)
        real_video = torch.cat([p, m, f], dim=1)

        logits_fake = functional_call(disc, params, (fake_video,), {"train": True})
        labels = disc_window_labels(K, T, F, self.cfg.disc_window_size, device=logits_fake.device)
        loss_fake = bce_with_logits(logits_fake, labels.expand_as(logits_fake))

        logits_real = functional_call(disc, params, (real_video,), {"train": True})
        loss_real = bce_with_logits(logits_real, torch.ones_like(logits_real))
        return loss_fake + loss_real, {"D_fake": loss_fake, "D_real": loss_real}

    # -- the step ---------------------------------------------------------------
    def _g_update(self, state: TrainState, K: int, T: int, F: int, targets: torch.Tensor) -> Tuple[torch.Tensor, Terms]:
        """One Adam step of the generator; returns its prediction (detached) and the G terms."""
        loss, (out, terms) = self._g_loss(state, K, T, F, targets)
        _set_grads(state.generator, loss, self.group)
        state.g_opt.step()
        state.step += 1
        return out["pred"].detach(), {k: v.detach() for k, v in terms.items()}

    def _d_update(self, state: TrainState, pred: torch.Tensor, K: int, T: int, F: int,
                  targets: torch.Tensor) -> Terms:
        """One Adam step of the discriminator on ``pred``; returns the D terms."""
        loss, terms = self._d_loss(state, pred, K, T, F, targets)
        _set_grads(state.discriminator, loss, self.group)
        state.d_opt.step()
        return {k: v.detach().float() for k, v in terms.items()}

    def train_step(self, state: TrainState, K: int, T: int, F: int, targets) -> Tuple[TrainState, Terms]:
        """One G update followed by one D update, in place.

        Leaves each parameter's ``.grad`` at this step's gradient; returns the
        state and the loss terms (0-d float32 tensors on the device).
        """
        targets = torch.as_tensor(targets, dtype=torch.float32, device=state.device)
        pred, terms = self._g_update(state, K, T, F, targets)
        terms.update(self._d_update(state, pred, K, T, F, targets))
        return state, terms

    def sample_ktf(self, rng: np.random.RandomState, allow_random: bool):
        c = self.cfg
        if not allow_random:
            return c.K, c.T, c.F
        return (
            rng.randint(self.min_K, c.K + 1),
            rng.randint(1, c.T + 1),
            rng.randint(self.min_F, c.F + 1),
        )


class TAIEnvironment(L2GDLDiscEnvironment):
    """Adds the intermediate forward/backward reconstruction and GDL losses;
    K, F >= 2 sampling."""

    min_K = 2
    min_F = 2

    def _extra_recon_terms(self, out, gt_middle) -> Terms:
        gt01 = inverse_transform(gt_middle)
        fwd01 = inverse_transform(out["pred_forward"])
        bwd01 = inverse_transform(out["pred_backward"])
        return {
            "G_Lp_forward": l2_loss(fwd01, gt01),
            "G_Lp_backward": l2_loss(bwd01, gt01),
            "G_gdl_forward": gdl_loss(fwd01, gt01),
            "G_gdl_backward": gdl_loss(bwd01, gt01),
        }


class MCNetEnvironment(L2GDLDiscEnvironment):
    """The forward-only MC-Net baseline: L2 + GDL + SN-GAN; K >= 2 sampling."""

    min_K = 2


class SCTEnvironment(L2GDLDiscEnvironment):
    """The SCT family: L2 + GDL + SN-GAN with sigmoid-scheduled teacher
    forcing.  With probability ``tf_rate(step)`` a model that has
    ``forward_train`` consumes the ground-truth middle frames (shifted by
    one) as its decoder inputs; otherwise it runs free.  The choice, and any
    random generation order, are drawn from the state's ``rng`` (seeded from
    ``init_state``'s ``seed``): a uniform draw against the rate, then the
    orders, as vfi_tpu splits its key.  ``teacher_forced`` (1 or 0) joins the
    step's terms."""

    def init_state(self, image_size: Tuple[int, int], **kwargs) -> TrainState:
        state = super().init_state(image_size, **kwargs)
        state.rng = torch.Generator().manual_seed(kwargs.get("seed", 0))
        return state

    def tf_rate(self, step: int) -> float:
        c = self.cfg
        x = (step - c.tf_offset) / c.tf_decay
        sig = 1.0 / (1.0 + math.exp(-x)) if x >= 0 else math.exp(x) / (1.0 + math.exp(x))
        return (c.tf_p_min - c.tf_p_max) * sig + c.tf_p_max

    def _teacher_forcing(self, state: TrainState) -> bool:
        """One uniform draw from the state's rng against ``tf_rate(step)``."""
        return bool(torch.rand((), generator=state.rng) < self.tf_rate(state.step))

    def _g_forward(self, state: TrainState, T: int, p, m, f) -> Dict[str, torch.Tensor]:
        gen = state.generator
        kwargs = {}
        forced = hasattr(gen, "forward_train") and self._teacher_forcing(state)
        if forced:
            (kwargs["gt_middle"],) = self._compute_cast((m,))
        if gen.random_order:
            kwargs["generator"] = state.rng
        out = functional_call(gen, self._cast_params(gen), (T, p, f), kwargs)
        return {**out, "teacher_forced": torch.tensor(float(forced), device=p.device)}

    def _g_loss(self, state: TrainState, K: int, T: int, F: int, targets: torch.Tensor):
        loss, (out, terms) = super()._g_loss(state, K, T, F, targets)
        terms["teacher_forced"] = out.pop("teacher_forced")
        return loss, (out, terms)


def create_training_environment(model: nn.Module, cfg, group=None) -> BaseEnvironment:
    """The environment for a generator, as vfi_tpu dispatches: TAI, TWI (a
    TAI subclass), bi-SA and bi-TWA train in :class:`TAIEnvironment`, MC-Net
    in :class:`MCNetEnvironment`, the SCT family in :class:`SCTEnvironment`,
    Super SloMo in ``slomo_env.SloMoEnvironment``; any other model raises
    ``TypeError``.  With a process ``group`` (``parallel.Groups.device``),
    every update averages its gradients over the group's ranks.
    Raises ``RuntimeError`` when ``VFI_INT8`` asks for vfi_tpu's int8 convs,
    which are inference-only (their rounding has a zero gradient)."""
    if os.environ.get("VFI_INT8", "0") in ("1", "2"):
        raise RuntimeError("VFI_INT8 is set but int8 convs are inference-only (zero gradients through the "
                           "rounding); unset it for training")
    if isinstance(model, (TAIFillInModel, BidirectionalSimpleAverageFillInModel,
                          BidirectionalTimeWeightedAverageFillInModel)):
        return TAIEnvironment(model, cfg, group)
    if isinstance(model, MCNetFillInModel):
        return MCNetEnvironment(model, cfg, group)
    if isinstance(model, SloMoFillInModel):
        from .slomo_env import SloMoEnvironment

        return SloMoEnvironment(model, cfg, group)
    if isinstance(model, BaseSCTFillInModel):
        return SCTEnvironment(model, cfg, group)
    raise TypeError(f"no training environment for model type {type(model).__name__}")


def create_eval_environment(model: nn.Module, cfg) -> BaseEnvironment:
    """An evaluation environment; ``needs_snapshot`` is false for a model
    without parameters, which serves without a snapshot."""
    env = BaseEnvironment(model, cfg)
    env.needs_snapshot = any(True for _ in model.parameters())
    return env

"""Dynamic-(K, T, F) training (counterpart of ``vfi_tpu/train/dynamic_env.py``).

    env = create_dynamic_environment(create_model("TAI_gray"), TrainConfig(K=5, T=5, F=5))
    state = env.init_state((128, 128))
    ktf = torch.tensor(env.sample_ktf(rng, True), device=state.device)
    state, terms = env.train_step_dynamic(state, targets, ktf)   # targets [B, 15, H, W, C]

``train_step_dynamic`` runs one step at the largest lengths (``cfg.K``,
``cfg.T``, ``cfg.F``) for every sampled (K, T, F): the clip's first K+T+F
frames are packed into pad-to-max buffers (``ops/dynamic.py``) and every
model, loss and discriminator window reads masks built on the device from
``ktf``.  No length is read on the host, so a step launches the same
kernels at every (K, T, F).  Its terms and its update equal the static
``train_step`` on ``targets[:, :K+T+F]`` up to float reassociation: a masked
warm-up step leaves the ConvLSTM state as it was, each loss is a mean over
the valid frames, and the discriminator scores the valid windows of the
compact video.

As ``train_step`` does, the step updates the state in place, averages each
update's gradients over the environment's process group, casts to bf16 for
compute under ``cfg.train_dtype == "bfloat16"`` with float32 losses, scores
the G update's detached prediction from before that update in the D update,
and writes the spectral-norm state fake, then real.  ``ktf`` is a ``[3]``
integer tensor or three values; values on the host are checked against the
environment's ranges (``min_K <= K <= cfg.K``, ``1 <= T <= cfg.T``,
``min_F <= F <= cfg.F``) and raise ``ValueError`` outside them.

Eager PyTorch does the padded step's work at the largest lengths at every
iteration, so ``cli/train.py --sample_KTF`` keeps the static step
(``PERF.md`` has the ratio on the card).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from ..models.fill_in import (BidirectionalSimpleAverageFillInModel, BidirectionalTimeWeightedAverageFillInModel,
                              MCNetFillInModel, TAIFillInModel)
from ..models.legacy_sct import SCTSkipConFillInModel, SCTSuperSkipConFillInModel
from ..models.sct import BaseSCTFillInModel
from ..models.slomo import SloMoFillInModel
from ..ops.dynamic import (Lengths, as_lengths, compact_video, dynamic_window_labels, masked_mean, middle_mask,
                           pack_context)
from ..ops.image import inverse_transform
from ..ops.warp import flow_warp
from .environments import L2GDLDiscEnvironment, SCTEnvironment, TAIEnvironment, Terms, TrainState, refuse_int8
from .losses import gdl_loss
from .slomo_env import SloMoEnvironment, _nchw


def _masked_gdl(pred: torch.Tensor, target: torch.Tensor, tmask: torch.Tensor) -> torch.Tensor:
    """``losses.gdl_loss`` over the valid middle frames (``tmask`` broadcasts over ``[B, T]``)."""
    pw = pred[..., :, :-1, :] - pred[..., :, 1:, :]
    ph = pred[..., 1:, :, :] - pred[..., :-1, :, :]
    tw = target[..., :, :-1, :] - target[..., :, 1:, :]
    th = target[..., 1:, :, :] - target[..., :-1, :, :]
    w_term = (pw - tw).abs()[..., 1:, :, :]
    h_term = (ph - th).abs()[..., :, 1:, :]
    return masked_mean(w_term + h_term, tmask)


def _masked_bce(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Sigmoid cross-entropy in the promoted dtype, averaged over the valid windows."""
    dt = torch.promote_types(logits.dtype, labels.dtype)
    return masked_mean(F.binary_cross_entropy_with_logits(logits.to(dt), labels.to(dt), reduction="none"), valid)


class _DynamicLengths:
    """``ktf`` and ``targets`` of a dynamic step, checked and on the state's
    device; the environment's ``min_K`` and ``min_F`` bound K and F."""

    def _dynamic_inputs(self, state: TrainState, targets, ktf) -> Tuple[torch.Tensor, Lengths]:
        c = self.cfg
        targets = torch.as_tensor(targets, dtype=torch.float32, device=state.device)
        if targets.shape[1] < c.K + c.T + c.F:
            raise ValueError(f"a dynamic step takes clips of {c.K + c.T + c.F} frames (cfg.K + cfg.T + cfg.F); "
                             f"got {targets.shape[1]}")
        return targets, as_lengths(ktf, state.device, (c.K, c.T, c.F), (self.min_K, 1, self.min_F))


class DynamicKTFMixin(_DynamicLengths):
    """A GAN environment's dynamic step, ``train_step_dynamic(state, targets, ktf)``."""

    use_intermediate_losses = False  # True for the TAI family

    def _g_loss_dyn(self, state: TrainState, K, T, F, targets: torch.Tensor):
        """(loss, (outputs, the packed (p, m, f), terms)); the discriminator runs with ``train=False``."""
        c = self.cfg
        p, m, f = pack_context(targets, K, T, F, c.K, c.T, c.F)
        p, f = self._compute_cast((p, f))
        out = self._g_forward(state, c.T, p, m, f, lengths=(K, T, F))
        forced = out.pop("teacher_forced", None)
        out = {k: a.float() for k, a in out.items()}
        p, f = p.float(), f.float()
        tmask = middle_mask(T, c.T)[None, :, None, None, None]

        def recon(key):
            pred01, gt01 = inverse_transform(out[key]), inverse_transform(m)
            return masked_mean((pred01 - gt01) ** 2, tmask), _masked_gdl(pred01, gt01, tmask)

        terms: Terms = dict(zip(("G_Lp", "G_gdl"), recon("pred")))
        extra: Terms = {}
        if self.use_intermediate_losses:
            for side in ("forward", "backward"):
                extra[f"G_Lp_{side}"], extra[f"G_gdl_{side}"] = recon(f"pred_{side}")

        fake = compact_video(p, out["pred"], f, K, T, F)
        logits = state.discriminator(fake, train=False)
        _, valid = dynamic_window_labels(K, T, F, fake.shape[1], c.disc_window_size)
        terms["G_GAN"] = _masked_bce(logits, torch.ones_like(logits), valid)

        loss = c.alpha * (terms["G_Lp"] + terms["G_gdl"] + sum(extra.values())) + c.beta * terms["G_GAN"]
        terms.update(extra)
        terms["G_loss"] = loss
        if forced is not None:
            terms["teacher_forced"] = forced
        return loss, (out, (p, m, f), terms)

    def _d_loss_dyn(self, state: TrainState, pred: torch.Tensor, p, m, f, K, T, F):
        """(loss, terms), as ``_d_loss`` on the compact videos' valid windows."""
        disc = state.discriminator
        params = self._cast_params(disc)
        p, m, f, pred = self._compute_cast((p, m, f, pred.detach()))
        fake = compact_video(p, pred, f, K, T, F)
        real = compact_video(p, m, f, K, T, F)
        labels, valid = dynamic_window_labels(K, T, F, fake.shape[1], self.cfg.disc_window_size)

        logits_fake = functional_call(disc, params, (fake,), {"train": True})
        loss_fake = _masked_bce(logits_fake, labels.expand_as(logits_fake), valid)
        logits_real = functional_call(disc, params, (real,), {"train": True})
        loss_real = _masked_bce(logits_real, torch.ones_like(logits_real), valid)
        return loss_fake + loss_real, {"D_fake": loss_fake, "D_real": loss_real}

    def train_step_dynamic(self, state: TrainState, targets, ktf) -> Tuple[TrainState, Terms]:
        """One G update then one D update at the lengths ``ktf``, in place, on
        the first K+T+F frames of the clips ``targets``
        ``[B, >= cfg.K+cfg.T+cfg.F, H, W, C]``.  Leaves each parameter's
        ``.grad`` at this step's gradient; returns the state and the terms
        (0-d float32 tensors on the device)."""
        targets, (K, T, F) = self._dynamic_inputs(state, targets, ktf)
        loss, (out, packed, terms) = self._g_loss_dyn(state, K, T, F, targets)
        self._adam_step(state.generator, state.g_opt, loss)
        state.step += 1
        terms = {k: v.detach() for k, v in terms.items()}
        d_loss, d_terms = self._d_loss_dyn(state, out["pred"].detach(), *packed, K, T, F)
        self._adam_step(state.discriminator, state.d_opt, d_loss)
        terms.update({k: v.detach().float() for k, v in d_terms.items()})
        return state, terms


class DynamicL2GDLDiscEnvironment(DynamicKTFMixin, L2GDLDiscEnvironment):
    pass


class DynamicMCNetEnvironment(DynamicL2GDLDiscEnvironment):
    min_K = 2


class DynamicTAIEnvironment(DynamicKTFMixin, TAIEnvironment):
    """TAI, TWI, bi-SA and bi-TWA, with the intermediate forward / backward losses."""

    use_intermediate_losses = True


class DynamicSCTEnvironment(DynamicKTFMixin, SCTEnvironment):
    """The SCT family on the sigmoid teacher-forcing schedule: the choice is a
    uniform draw from the state's ``rng`` on the host (a Python branch where
    vfi_tpu traces both under ``lax.cond``), and random orders are drawn from
    the same generator over the sampled T's valid steps."""


class DynamicSloMoEnvironment(_DynamicLengths, SloMoEnvironment):
    """Super SloMo's dynamic step (no discriminator), with ``SloMoEnvironment``'s
    perceptual loss, rate schedule and Adam.

    Every loss over the middle frames is a mean over the valid ones, the
    VGG16 perceptual term included: vfi_tpu's dynamic SloMo step takes that
    term over all max_T frames, the padding's included, and so departs from
    its own static step whenever T < max_T; this step equals the static one."""

    min_K = 1
    min_F = 1

    def _g_loss_dyn(self, state: TrainState, K, T, F, targets: torch.Tensor):
        c = self.cfg
        p, m, f = pack_context(targets, K, T, F, c.K, c.T, c.F)
        out = functional_call(state.generator, self._cast_params(state.generator),
                              (c.T, *self._compute_cast((p, f))), {"lengths": (K, T, F)})
        out = {k: a.float() for k, a in out.items()}
        pred = out["pred"]
        tmask = middle_mask(T, c.T)
        tmask5 = tmask[None, :, None, None, None]

        terms: Terms = {"reconstruction_loss": masked_mean((pred - m).abs(), tmask5)}
        terms["perceptual_loss"] = (self._perceptual(pred, m, tmask) if self._vgg is not None
                                    else pred.new_zeros(()))

        # The per-t warps over the valid middle frames, and the cross-warps of I0 and I1.
        I0, I1 = _nchw(p[:, -1]), _nchw(f[:, 0])
        B = I0.shape[0]
        I0r = I0[:, None].expand(B, c.T, *I0.shape[1:]).flatten(0, 1)
        I1r = I1[:, None].expand(B, c.T, *I1.shape[1:]).flatten(0, 1)
        mid = _nchw(m)
        tmask3 = tmask[None, :, None]

        def per_t(a, flows):
            return masked_mean((flow_warp(a, _nchw(flows)) - mid).abs().reshape(B, c.T, -1), tmask3)

        terms["warping_loss"] = ((flow_warp(I0, _nchw(out["F_1_0"])) - I1).abs().mean()
                                 + (flow_warp(I1, _nchw(out["F_0_1"])) - I0).abs().mean()
                                 + per_t(I0r, out["F_t_0_collector"]) + per_t(I1r, out["F_t_1_collector"]))
        zero = torch.zeros_like(out["F_0_1"])
        terms["smooth_loss"] = gdl_loss(out["F_1_0"], zero) + gdl_loss(out["F_0_1"], zero)

        loss = (c.lambda_r * terms["reconstruction_loss"] + c.lambda_p * terms["perceptual_loss"]
                + c.lambda_w * terms["warping_loss"] + c.lambda_s * terms["smooth_loss"])
        terms["G_loss"] = loss
        return loss, terms

    def train_step_dynamic(self, state: TrainState, targets, ktf) -> Tuple[TrainState, Terms]:
        """One Adam step of the generator at the lengths ``ktf``, in place, as ``train_step``."""
        targets, (K, T, F) = self._dynamic_inputs(state, targets, ktf)
        return self._update(state, *self._g_loss_dyn(state, K, T, F, targets))


_LEGACY_SCT = (SCTSkipConFillInModel, SCTSuperSkipConFillInModel)


def create_dynamic_environment(model: nn.Module, cfg, group=None):
    """The dynamic-(K, T, F) counterpart of ``create_training_environment``:
    TAI, TWI, bi-SA and bi-TWA train in :class:`DynamicTAIEnvironment`, MC-Net
    in :class:`DynamicMCNetEnvironment`, Super SloMo in
    :class:`DynamicSloMoEnvironment` and the 8 SCT variants in
    :class:`DynamicSCTEnvironment`; any other model gets None, and its caller
    runs the static step, as vfi_tpu's train CLI does on None.

    The two legacy SCT classes get None: their forwards take no ``lengths``,
    as vfi_tpu's do not, where vfi_tpu's ``create_dynamic_environment`` still
    returns its SCT environment, whose first step raises ``TypeError``.
    Refuses ``VFI_INT8`` (``environments.refuse_int8``)."""
    refuse_int8()
    if isinstance(model, _LEGACY_SCT):
        return None
    if isinstance(model, (TAIFillInModel, BidirectionalSimpleAverageFillInModel,
                          BidirectionalTimeWeightedAverageFillInModel)):
        return DynamicTAIEnvironment(model, cfg, group)
    if isinstance(model, MCNetFillInModel):
        return DynamicMCNetEnvironment(model, cfg, group)
    if isinstance(model, SloMoFillInModel):
        return DynamicSloMoEnvironment(model, cfg, group)
    if isinstance(model, BaseSCTFillInModel):
        return DynamicSCTEnvironment(model, cfg, group)
    return None

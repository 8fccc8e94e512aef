"""Super SloMo training (counterpart of ``vfi_tpu/train/slomo_env.py``).

    env = create_training_environment(create_model("SloMoFillInModel_color"),
                                      TrainConfig(K=4, T=3, F=4, vgg16_weights="vgg16.npz"))
    state = env.init_state((160, 192))                # no discriminator
    state, terms = env.train_step(state, K, T, F, targets)

The loss is vfi_tpu's: ``lambda_r`` L1 reconstruction + ``lambda_p`` VGG16
perceptual (relu4_3, the L2 of the features) + ``lambda_w`` warping + ``lambda_s``
smoothness (GDL of both flows against zero); no discriminator.  Adam(beta1,
0.999) at the step-decay rate ``lr * lr_decay_rate ** (step // lr_decay_count)``,
read at the update's count as optax reads its schedule: each ``train_step``
sets the rate from the state's step before the update, so a resumed state
trains at its step's rate.  ``lambda_p > 0`` without VGG16 weights
(``cfg.vgg16_weights``, an ``.npz``) raises, as in vfi_tpu.

Under ``cfg.train_dtype == "bfloat16"`` the generator and the VGG16 head run
on bf16 copies of their float32 weights, as the GAN environments cast, and
every loss is taken in float32; vfi_tpu's SloMo environment ignores
``train_dtype`` and trains in float32.
"""

from __future__ import annotations

import copy
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from ..api import resolve_device
from ..nn.vgg import try_load_vgg16
from ..ops.dynamic import masked_mean
from ..ops.image import inverse_transform
from ..ops.warp import flow_warp
from ..utils.params import params_from_jax
from .environments import BaseEnvironment, Terms, TrainState, _set_grads, split_batch
from .losses import gdl_loss, l1_loss, l2_loss


def _nchw(frames: torch.Tensor) -> torch.Tensor:
    """Channels-last frames ``[..., H, W, C]`` -> ``[N, C, H, W]``."""
    return frames.reshape(-1, *frames.shape[-3:]).permute(0, 3, 1, 2)


class SloMoEnvironment(BaseEnvironment):
    def __init__(self, model: nn.Module, cfg, group=None):
        super().__init__(model, cfg, group)
        self._vgg = try_load_vgg16(cfg.vgg16_weights)
        if self._vgg is None and cfg.lambda_p > 0:
            raise RuntimeError(
                "SloMo training with lambda_p > 0 requires VGG16 weights: pass "
                "--vgg16_weights <npz> (convert a torchvision vgg16 state_dict "
                "with cli/convert_vgg16.py), or explicitly opt out of reference "
                "parity with --lambda_p 0."
            )

    def init_state(self, image_size: Tuple[int, int], *, g_params=None, device=None, seed: int = 0) -> TrainState:
        """A fresh state (no discriminator) on ``device`` (``cuda`` unless
        ``"cpu"`` is asked for); ``g_params`` are vfi_tpu generator params,
        by default a copy of the environment's model.  ``image_size`` and
        ``seed`` are accepted as the GAN environments take them: this state
        draws nothing."""
        del image_size, seed
        dev = resolve_device(device)
        generator = copy.deepcopy(self.model)
        if g_params is not None:
            generator.load_state_dict(params_from_jax(g_params))
        generator.to(dev).train()
        if self._vgg is not None:
            self._vgg.to(dev)
        return TrainState(generator, None, self._adam(generator), None)

    def learning_rate(self, step: int) -> float:
        c = self.cfg
        return c.lr * c.lr_decay_rate ** (step // c.lr_decay_count)

    def _perceptual(self, pred: torch.Tensor, gt: torch.Tensor, tmask=None) -> torch.Tensor:
        """L2 between the VGG16 features of the predicted and the true middle
        frames ``[B, T, H, W, C]``; with a middle-frame mask ``[T]``, the mean
        over the valid frames' features alone."""
        params = self._cast_params(self._vgg)

        def feats(v):
            x = _nchw(inverse_transform(v))
            if x.shape[1] == 1:
                x = x.expand(-1, 3, -1, -1)
            (x,) = self._compute_cast((x,))
            return functional_call(self._vgg, params, (x,)).float()

        with torch.no_grad():  # no gradient reaches the ground truth
            want = feats(gt)
        if tmask is None:
            return l2_loss(feats(pred), want)
        return masked_mean(((feats(pred) - want) ** 2).reshape(*pred.shape[:2], -1), tmask[None, :, None])

    def _g_loss(self, state: TrainState, K: int, T: int, F: int, targets: torch.Tensor):
        c = self.cfg
        p, m, f = split_batch(targets, K, T, F)
        out = functional_call(state.generator, self._cast_params(state.generator), (T, *self._compute_cast((p, f))))
        out = {k: a.float() for k, a in out.items()}
        pred = out["pred"]

        terms: Terms = {"reconstruction_loss": l1_loss(pred, m)}
        terms["perceptual_loss"] = self._perceptual(pred, m) if self._vgg is not None else pred.new_zeros(())

        # Warping: the per-t warps of the two context frames toward every true
        # middle frame, and the cross-warps of I0 and I1 (vfi_tpu's "pixel" mode).
        I0, I1 = _nchw(p[:, -1]), _nchw(f[:, 0])
        B = I0.shape[0]
        I0r = I0[:, None].expand(B, T, *I0.shape[1:]).flatten(0, 1)
        I1r = I1[:, None].expand(B, T, *I1.shape[1:]).flatten(0, 1)
        mid = _nchw(m)
        per_t = (l1_loss(flow_warp(I0r, _nchw(out["F_t_0_collector"])), mid)
                 + l1_loss(flow_warp(I1r, _nchw(out["F_t_1_collector"])), mid))
        terms["warping_loss"] = (l1_loss(flow_warp(I0, _nchw(out["F_1_0"])), I1)
                                 + l1_loss(flow_warp(I1, _nchw(out["F_0_1"])), I0) + per_t)

        zero = torch.zeros_like(out["F_0_1"])
        terms["smooth_loss"] = gdl_loss(out["F_1_0"], zero) + gdl_loss(out["F_0_1"], zero)

        loss = (c.lambda_r * terms["reconstruction_loss"] + c.lambda_p * terms["perceptual_loss"]
                + c.lambda_w * terms["warping_loss"] + c.lambda_s * terms["smooth_loss"])
        terms["G_loss"] = loss
        return loss, terms

    def train_step(self, state: TrainState, K: int, T: int, F: int, targets) -> Tuple[TrainState, Terms]:
        """One Adam step of the generator at ``learning_rate(state.step)``, in
        place; leaves each parameter's ``.grad`` at this step's gradient and
        returns the state and the loss terms (0-d float32 tensors on the device)."""
        targets = torch.as_tensor(targets, dtype=torch.float32, device=state.device)
        return self._update(state, *self._g_loss(state, K, T, F, targets))

    def _update(self, state: TrainState, loss: torch.Tensor, terms: Terms) -> Tuple[TrainState, Terms]:
        """One Adam step on ``loss`` at ``learning_rate(state.step)``; the state and the detached terms."""
        for group in state.g_opt.param_groups:
            group["lr"] = self.learning_rate(state.step)
        _set_grads(state.generator, loss, self.group)
        state.g_opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in terms.items()}

    def sample_ktf(self, rng: np.random.RandomState, allow_random: bool):
        """(K, T, F), each uniform from 1 under ``--sample_KTF``."""
        c = self.cfg
        if not allow_random:
            return c.K, c.T, c.F
        return rng.randint(1, c.K + 1), rng.randint(1, c.T + 1), rng.randint(1, c.F + 1)

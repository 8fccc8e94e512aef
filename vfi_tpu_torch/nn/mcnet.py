"""MC-Net, the shared autoregressive video predictor (counterpart of
``vfi_tpu/nn/mcnet.py``).

The modules compute in NCHW.  :class:`MCNet` takes vfi_tpu's channels-last
inputs and returns its rollout as NCHW tensors stacked over a leading T axis.

``remat`` is vfi_tpu's: while autograd records, the seven submodules of a
rollout step that vfi_tpu wraps in ``nn.remat`` (``MotionEnc``,
``ContentEnc``, ``CombLayers``, ``Residual`` x3, ``DecCnn``) run under
``torch.utils.checkpoint`` and are recomputed in the backward pass; the
ConvLSTM cell is stored as vfi_tpu stores it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..ops.image import fixed_unpooling, to_gray_frames
from .layers import Conv, ConvLSTMCell, max_pool2


class MotionEnc(nn.Module):
    """Difference-frame encoder; returns the encoding and 3 residual activations."""

    def __init__(self, gf_dim: int, c_in: int = 1):
        super().__init__()
        g = gf_dim
        self.dyn1 = Conv(c_in, g, 5)
        self.dyn2 = Conv(g, g * 2, 5)
        self.dyn3 = Conv(g * 2, g * 4, 7)

    def forward(self, diff):
        r1 = F.relu(self.dyn1(diff))
        r2 = F.relu(self.dyn2(max_pool2(r1)))
        r3 = F.relu(self.dyn3(max_pool2(r2)))
        return max_pool2(r3), (r1, r2, r3)


class ContentEnc(nn.Module):
    """Raw-frame encoder (2/2/3-layer stages)."""

    def __init__(self, gf_dim: int, c_dim: int):
        super().__init__()
        g = gf_dim
        self.c1a = Conv(c_dim, g, 3)
        self.c1b = Conv(g, g, 3)
        self.c2a = Conv(g, g * 2, 3)
        self.c2b = Conv(g * 2, g * 2, 3)
        self.c3a = Conv(g * 2, g * 4, 3)
        self.c3b = Conv(g * 4, g * 4, 3)
        self.c3c = Conv(g * 4, g * 4, 3)

    def forward(self, frame):
        x = F.relu(self.c1a(frame))
        r1 = F.relu(self.c1b(x))
        x = F.relu(self.c2a(max_pool2(r1)))
        r2 = F.relu(self.c2b(x))
        x = F.relu(self.c3a(max_pool2(r2)))
        x = F.relu(self.c3b(x))
        r3 = F.relu(self.c3c(x))
        return max_pool2(r3), (r1, r2, r3)


class CombLayers(nn.Module):
    """Fuse the motion and content encodings."""

    def __init__(self, gf_dim: int):
        super().__init__()
        g = gf_dim
        self.comb1 = Conv(g * 8, g * 4, 3)
        self.comb2 = Conv(g * 4, g * 2, 3)
        self.comb3 = Conv(g * 2, g * 4, 3)

    def forward(self, h_dyn, h_cont):
        x = F.relu(self.comb1(torch.cat([h_dyn, h_cont], dim=1)))
        x = F.relu(self.comb2(x))
        return F.relu(self.comb3(x))


class Residual(nn.Module):
    """conv-relu-conv over the channel concatenation ``[a, b]``."""

    def __init__(self, in_features: int, out_dim: int):
        super().__init__()
        self.res1 = Conv(in_features, out_dim, 3)
        self.res2 = Conv(out_dim, out_dim, 3)

    def forward(self, a, b):
        return self.res2(F.relu(self.res1(torch.cat([a, b], dim=1))))


class DecCnn(nn.Module):
    """3-stage decoder with zero-stuffing unpooling and residual skips; tanh output."""

    def __init__(self, c_dim: int, gf_dim: int):
        super().__init__()
        g = gf_dim
        self.d3a = Conv(g * 4, g * 4, 3)
        self.d3b = Conv(g * 4, g * 4, 3)
        self.d3c = Conv(g * 4, g * 2, 3)
        self.d2a = Conv(g * 2, g * 2, 3)
        self.d2b = Conv(g * 2, g, 3)
        self.d1a = Conv(g, g, 3)
        self.d1b = Conv(g, c_dim, 3)

    def forward(self, comb, res1, res2, res3):
        x = fixed_unpooling(comb) + res3
        x = F.relu(self.d3a(x))
        x = F.relu(self.d3b(x))
        x = F.relu(self.d3c(x))
        x = fixed_unpooling(x) + res2
        x = F.relu(self.d2a(x))
        x = F.relu(self.d2b(x))
        x = fixed_unpooling(x) + res1
        x = F.relu(self.d1a(x))
        return torch.tanh(self.d1b(x))


class RolloutStep(NamedTuple):
    """Per-timestep rollout outputs, NCHW, stacked over a leading T axis."""

    pred: torch.Tensor  # [T, B, C, H, W]
    dyn: torch.Tensor  # [T, B, 4g, H/8, W/8]
    cont: torch.Tensor  # [T, B, 4g, H/8, W/8]
    res1: torch.Tensor  # [T, B, g, H, W]
    res2: torch.Tensor  # [T, B, 2g, H/2, W/2]
    res3: torch.Tensor  # [T, B, 4g, H/4, W/4]


def _gray_nchw(frames: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] in [-1, 1] -> [B, 1, H, W] grayscale in [0, 1]."""
    return to_gray_frames(frames.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class MCNet(nn.Module):
    """K-1 warm-up steps over difference frames, then a T-step autoregressive
    rollout that re-feeds predicted-frame differences."""

    def __init__(self, gf_dim: int, c_dim: int, lstm_kernel: int = 3, forget_bias: float = 1.0,
                 remat: bool = False):
        super().__init__()
        self.gf_dim = gf_dim
        self.remat = remat
        self.motion_enc = MotionEnc(gf_dim)
        self.content_enc = ContentEnc(gf_dim, c_dim)
        self.conv_lstm = ConvLSTMCell(4 * gf_dim, 4 * gf_dim, lstm_kernel, forget_bias)
        self.comb_layers = CombLayers(gf_dim)
        self.residual1 = Residual(gf_dim * 2, gf_dim)
        self.residual2 = Residual(gf_dim * 4, gf_dim * 2)
        self.residual3 = Residual(gf_dim * 8, gf_dim * 4)
        self.dec_cnn = DecCnn(c_dim, gf_dim)

    def _call(self, module: nn.Module, *args):
        """``module(*args)``, checkpointed under ``remat`` while autograd records.
        The recomputation gets the parameters the forward used, so a module
        run on cast copies (``functional_call``) recomputes on the same copies."""
        if not (self.remat and torch.is_grad_enabled()):
            return module(*args)
        return checkpoint(functional_call, module, dict(module.named_parameters()), args, use_reentrant=False)

    def _predict(self, xt, h_dyn, res_m) -> RolloutStep:
        h_cont, res_c = self._call(self.content_enc, xt)
        h_tpl = self._call(self.comb_layers, h_dyn, h_cont)
        r1 = self._call(self.residual1, res_m[0], res_c[0])
        r2 = self._call(self.residual2, res_m[1], res_c[1])
        r3 = self._call(self.residual3, res_m[2], res_c[2])
        return RolloutStep(self._call(self.dec_cnn, h_tpl, r1, r2, r3), h_dyn, h_cont, r1, r2, r3)

    def forward(self, T: int, diff_in: torch.Tensor, xt: torch.Tensor, warmup_skip=None) -> RolloutStep:
        """
        :param T: number of frames to predict
        :param diff_in: grayscale difference frames ``[B, K-1, H, W, 1]``
        :param xt: the content frame (last context frame) ``[B, H, W, C]``
        :param warmup_skip: the dynamic-(K, T, F) path's count of *invalid*
            leading warm-up steps, a tensor ``[B]`` or 0-d (broadcast over the
            rows), where the preceding frames are right-aligned in a max_K
            buffer (``ops/dynamic.py``).  A masked step leaves the ConvLSTM
            state as it was, so the rollout equals the one after the shorter
            warm-up; the last step, which seeds the rollout, is always valid.
        """
        B, Km1, H, W, _ = diff_in.shape
        xt = xt.permute(0, 3, 1, 2)
        state = ConvLSTMCell.initial_state(B, H // 8, W // 8, 4 * self.gf_dim, xt.dtype, xt.device)

        # All warm-up difference frames are known up front: one batched
        # MotionEnc call over B*(K-1); only the ConvLSTM chain is sequential.
        flat = diff_in.reshape(B * Km1, H, W, 1).permute(0, 3, 1, 2)
        enc_all, res_all = self._call(self.motion_enc, flat)
        enc_all = enc_all.reshape(B, Km1, *enc_all.shape[1:])
        res_m = tuple(r.reshape(B, Km1, *r.shape[1:])[:, -1] for r in res_all)
        if warmup_skip is not None:
            warmup_skip = torch.as_tensor(warmup_skip, device=xt.device).reshape(-1, 1, 1, 1)
        h_dyn = None
        for t in range(Km1):
            h_dyn, new_state = self.conv_lstm(enc_all[:, t], state)
            if warmup_skip is None:
                state = new_state
            else:
                valid = (t >= warmup_skip).to(state.dtype)
                state = valid * new_state + (1.0 - valid) * state

        steps = [self._predict(xt, h_dyn, res_m)]
        for _ in range(1, T):
            x_hat = steps[-1].pred
            enc_h, res_m = self._call(self.motion_enc, _gray_nchw(x_hat) - _gray_nchw(xt))
            h_dyn, state = self.conv_lstm(enc_h, state)
            xt = x_hat
            steps.append(self._predict(xt, h_dyn, res_m))
        return RolloutStep(*(torch.stack(f) for f in zip(*steps)))

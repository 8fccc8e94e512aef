"""Super SloMo (Jiang et al. 2018) fill-in baseline (counterpart of
``vfi_tpu/models/slomo.py``).

Uses the last preceding and the first following frame: a 6-stage UNet
computes the bidirectional flows F_0_1 / F_1_0; for every middle time t the
flows are synthesised, refined by a second UNet, and the two warped frames
are blended with a learned visibility map.  As in vfi_tpu, all T middle
frames run as one batch through the refinement UNet (t-major), and ``pred``
is in natural time order.  Outputs are channels-last like the inputs:
``pred`` ``[B, T, H, W, C]``, ``F_0_1`` / ``F_1_0`` ``[B, H, W, 2]`` and the
synthesised flows ``F_t_0_collector`` / ``F_t_1_collector``
``[B, T, H, W, 2]``.  H and W must be multiples of 32 (five pools).
vfi_tpu's dynamic ``lengths`` argument is not ported: the port's
``--sample_KTF`` runs the static step at each sampled length.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.layers import Conv
from ..ops.image import time_weights, upsample2x_bilinear
from ..ops.warp import MODES, flow_warp

_ENC = [(1, 7), (2, 5), (4, 3), (8, 3), (16, 3), (16, 3)]  # (width multiple, kernel) per stage
_DEC = [(16, 8), (8, 4), (4, 2), (2, 1), (1, 1)]  # (width multiples of the two convs) per stage


class SloMoEncoder(nn.Module):
    """6-stage UNet encoder (7/7, 5/5, then 3/3 kernels), leaky ReLU 0.1."""

    def __init__(self, in_features: int, gf_dim: int, alpha: float = 0.1):
        super().__init__()
        self.alpha = alpha
        cin = in_features
        for i, (mult, k) in enumerate(_ENC):
            self.add_module(f"e{i}a", Conv(cin, gf_dim * mult, k))
            self.add_module(f"e{i}b", Conv(gf_dim * mult, gf_dim * mult, k))
            cin = gf_dim * mult

    def forward(self, x: torch.Tensor):
        skips = []
        for i in range(len(_ENC)):
            if i > 0:
                x = F.max_pool2d(x, 2)
            x = F.leaky_relu(getattr(self, f"e{i}a")(x), self.alpha)
            x = F.leaky_relu(getattr(self, f"e{i}b")(x), self.alpha)
            if i < len(_ENC) - 1:
                skips.append(x)
        return x, skips


class SloMoDecoder(nn.Module):
    """5-stage UNet decoder: corner-aligned bilinear 2x upsampling (the
    reference's torch-0.3 ``nn.Upsample``), skip concatenation, then a 1x1
    conv to ``out_dim``."""

    def __init__(self, gf_dim: int, out_dim: int, alpha: float = 0.1):
        super().__init__()
        self.alpha = alpha
        cin = gf_dim * 16
        for i, (m1, m2) in enumerate(_DEC):
            self.add_module(f"d{i}a", Conv(2 * cin, gf_dim * m1, 3))  # upsampled x + the skip, equally wide
            self.add_module(f"d{i}b", Conv(gf_dim * m1, gf_dim * m2, 3))
            cin = gf_dim * m2
        self.out = Conv(cin, out_dim, 1)

    def forward(self, x: torch.Tensor, skips) -> torch.Tensor:
        for i in range(len(_DEC)):
            x = torch.cat([upsample2x_bilinear(x, align_corners=True), skips[-(i + 1)]], dim=1)
            x = F.leaky_relu(getattr(self, f"d{i}a")(x), self.alpha)
            x = F.leaky_relu(getattr(self, f"d{i}b")(x), self.alpha)
        return self.out(x)


def _nchw(frames: torch.Tensor) -> torch.Tensor:
    return frames.permute(0, 3, 1, 2)


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    """``[..., C, H, W]`` -> ``[..., H, W, C]``."""
    return x.movedim(-3, -1)


class SloMoFillInModel(nn.Module):
    """``warp_mode`` is vfi_tpu's: ``"pixel"`` for training from scratch,
    ``"torch03"`` for imported reference checkpoints (``ops/warp.py``)."""

    def __init__(self, base_dim: int = 32, c_dim: int = 3, warp_mode: str = "pixel"):
        super().__init__()
        if warp_mode not in MODES:
            raise ValueError(f"unknown warp_mode {warp_mode!r}; one of {MODES}")
        self.base_dim, self.c_dim, self.warp_mode = base_dim, c_dim, warp_mode
        self.compute_enc = SloMoEncoder(2 * c_dim, base_dim)
        self.compute_dec = SloMoDecoder(base_dim, 4)
        self.refine_enc = SloMoEncoder(4 * c_dim + 4, base_dim)
        self.refine_dec = SloMoDecoder(base_dim, 5)

    def forward(self, T: int, preceding, following) -> Dict[str, torch.Tensor]:
        I0, I1 = _nchw(preceding[:, -1]), _nchw(following[:, 0])
        B = I0.shape[0]

        flows = torch.tanh(self.compute_dec(*self.compute_enc(torch.cat([I0, I1], dim=1))))
        F_0_1, F_1_0 = flows[:, :2], flows[:, 2:]

        # The per-t flows, t folded into the batch (t-major).
        t = time_weights(T, I0.dtype, I0.device)[:, None, None, None, None]  # [T, 1, 1, 1, 1]
        F_t_0 = (-(1 - t) * t * F_0_1 + t**2 * F_1_0).flatten(0, 1)  # [T*B, 2, H, W]
        F_t_1 = ((1 - t) * (1 - t) * F_0_1 - t * (1 - t) * F_1_0).flatten(0, 1)
        I0r = I0.expand(T, *I0.shape).flatten(0, 1)
        I1r = I1.expand(T, *I1.shape).flatten(0, 1)

        g_I0 = flow_warp(I0r, F_t_0, self.warp_mode)
        g_I1 = flow_warp(I1r, F_t_1, self.warp_mode)
        refine_in = torch.cat([I0r, g_I0, F_t_0, F_t_1, g_I1, I1r], dim=1)
        refine_out = self.refine_dec(*self.refine_enc(refine_in))
        V_t_0 = torch.sigmoid(refine_out[:, 4:5])
        V_t_1 = 1.0 - V_t_0
        g0 = flow_warp(I0r, torch.clamp(F_t_0 + torch.tanh(refine_out[:, 0:2]), -1.0, 1.0), self.warp_mode)
        g1 = flow_warp(I1r, torch.clamp(F_t_1 + torch.tanh(refine_out[:, 2:4]), -1.0, 1.0), self.warp_mode)

        tf = t.expand(T, B, 1, 1, 1).flatten(0, 1)
        interp = ((1 - tf) * V_t_0 * g0 + tf * V_t_1 * g1) / ((1 - tf) * V_t_0 + tf * V_t_1)

        def video(a):  # t-major [T*B, C, H, W] -> [B, T, H, W, C]
            return _channels_last(a.reshape(T, B, *a.shape[1:]).transpose(0, 1))

        return {
            "pred": video(interp),
            "F_0_1": _channels_last(F_0_1),
            "F_1_0": _channels_last(F_1_0),
            "F_t_0_collector": video(F_t_0),
            "F_t_1_collector": video(F_t_1),
        }

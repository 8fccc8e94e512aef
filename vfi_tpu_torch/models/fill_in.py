"""Fill-in models (counterpart of ``vfi_tpu/models/fill_in.py``), static-shape path.

Videos are batch-major channels-last ``[B, T, H, W, C]`` in [-1, 1], as in
vfi_tpu.  TAI and TWI return ``pred``, ``pred_forward``, ``pred_backward`` and
the two pre-blend interpolation-net outputs.

When K == F the forward and backward MC-Net rollouts run as one rollout over
the doubled batch ``[fwd; bwd]``; the per-timestep blend is folded into the
batch axis (t-major) so KernelNet runs once over B*T elements.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ..nn.kernelnet import KernelNet
from ..nn.mcnet import MCNet, Residual, RolloutStep
from ..ops.image import time_weights, to_gray_frames


def _diff_frames(frames: torch.Tensor) -> torch.Tensor:
    """Grayscale forward differences: [B, N, H, W, C] -> [B, N-1, H, W, 1]."""
    g = to_gray_frames(frames)
    return g[:, 1:] - g[:, :-1]


def _bt(x: torch.Tensor) -> torch.Tensor:
    """Time-major [T, B, ...] -> batch-major [B, T, ...]."""
    return x.transpose(0, 1)


def _fold(x: torch.Tensor) -> torch.Tensor:
    """[T, B, ...] -> [T*B, ...] (t-major, so the ratio repeats per t)."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def _video(x: torch.Tensor) -> torch.Tensor:
    """NCHW rollout [T, B, C, H, W] -> channels-last video [B, T, H, W, C]."""
    return x.permute(1, 0, 3, 4, 2)


class BidirectionalMCNetModel(nn.Module):
    """MC-Net forward from the preceding frames and backward from the
    time-reversed following frames."""

    def __init__(self, gf_dim: int, c_dim: int, feature_size: int = 3, forget_bias: float = 1.0):
        super().__init__()
        self.gf_dim, self.c_dim = gf_dim, c_dim
        self.mcnet = MCNet(gf_dim, c_dim, feature_size, forget_bias)

    def bidirectional_rollout(self, T: int, preceding, following) -> tuple[RolloutStep, RolloutStep]:
        """Both rollouts, time-major NCHW; the backward one back in natural time order."""
        B, K = preceding.shape[:2]
        xt, xt_b = preceding[:, -1], following[:, 0]
        diff_f = _diff_frames(preceding)
        diff_b = _diff_frames(following.flip(1))
        if K == following.shape[1]:
            out = self.mcnet(T, torch.cat([diff_f, diff_b]), torch.cat([xt, xt_b]))
            fwd = RolloutStep(*(a[:, :B] for a in out))
            bwd = RolloutStep(*(a[:, B:] for a in out))
        else:
            fwd = self.mcnet(T, diff_f, xt)
            bwd = self.mcnet(T, diff_b, xt_b)
        return fwd, RolloutStep(*(a.flip(0) for a in bwd))


class TAIFillInModel(BidirectionalMCNetModel):
    """bi-TAI: bidirectional MC-Net + time-aware adaptive-kernel blending.

    ``sepconv_impl`` is vfi_tpu's field of that name: :func:`sepconv`'s
    ``impl`` for the kernel net (None: the device's default; it holds no
    weights).
    """

    use_ratio = True

    def __init__(self, gf_dim: int, c_dim: int, feature_size: int = 3, forget_bias: float = 1.0,
                 ks: int = 51, num_block: int = 5, kf_dim: int = 32, layers: int = 3,
                 align_corners: bool = True, sepconv_impl: Optional[str] = None):
        super().__init__(gf_dim, c_dim, feature_size, forget_bias)
        self.merge_residual2 = Residual(gf_dim * 4, kf_dim * 2)
        self.merge_residual3 = Residual(gf_dim * 8, kf_dim * 4)
        self.kernelnet = KernelNet(gf_dim, ks, num_block, layers, kf_dim, use_ratio=self.use_ratio,
                                   align_corners=align_corners, sepconv_impl=sepconv_impl)

    def forward(self, T: int, preceding, following) -> Dict[str, torch.Tensor]:
        B = preceding.shape[0]
        fwd, bwd = self.bidirectional_rollout(T, preceding, following)
        m2 = self.merge_residual2(_fold(fwd.res2), _fold(bwd.res2))
        m3 = self.merge_residual3(_fold(fwd.res3), _fold(bwd.res3))

        w = time_weights(T, preceding.dtype, preceding.device)  # weight of the backward stream
        ratio = torch.repeat_interleave(1.0 - w, B)
        dot1, dot2 = self.kernelnet(
            _fold(fwd.pred), _fold(bwd.pred), _fold(fwd.dyn), _fold(bwd.dyn),
            _fold(fwd.cont), _fold(bwd.cont), m2, m3, ratio,
        )
        dot1 = dot1.reshape(T, B, *dot1.shape[1:])
        dot2 = dot2.reshape(T, B, *dot2.shape[1:])
        if self.use_ratio:
            comb = 0.5 * dot1 + 0.5 * dot2  # TAI blend
        else:
            wt = w[:, None, None, None, None]
            comb = (1.0 - wt) * dot1 + wt * dot2  # TWI blend
        return {
            "pred": _bt(comb),
            "pred_forward": _video(fwd.pred),
            "pred_backward": _video(bwd.pred),
            "interp_net_outputs_1": _bt(dot1),
            "interp_net_outputs_2": _bt(dot2),
        }


class TWIFillInModel(TAIFillInModel):
    """bi-TWI: time-agnostic kernel net + time-weighted blend."""

    use_ratio = False

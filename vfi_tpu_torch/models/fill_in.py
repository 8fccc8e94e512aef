"""Fill-in models (counterpart of ``vfi_tpu/models/fill_in.py``).

Videos are batch-major channels-last ``[B, T, H, W, C]`` in [-1, 1], as in
vfi_tpu.  Every model returns ``pred``; the bidirectional ones (TAI, TWI,
bi-TWA, bi-SA) add ``pred_forward`` and ``pred_backward``, and TAI and TWI
the two pre-blend interpolation-net outputs.

Every ``forward(T, preceding, following, lengths=None)`` takes vfi_tpu's
dynamic-(K, T, F) form: with ``lengths`` (a ``[3]`` tensor or three values,
``ops/dynamic.as_lengths``), ``preceding`` is a right-aligned max_K buffer,
``following`` a left-aligned max_F buffer and ``T`` is max_T
(``ops/dynamic.pack_context``); the outputs at t < the sampled T equal the
static forward's at those lengths, and those after it are finite padding.

The MC-Net models take vfi_tpu's ``remat`` (gradient checkpointing of the
rollout, ``nn/mcnet.py``) and ``scan_rollout``, which only shortens vfi_tpu's
XLA compiles: it is accepted and ignored.

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
from ..ops.dynamic import as_lengths, dynamic_time_weights, reverse_middle
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


def _lengths(lengths, T: int, preceding, following):
    """``lengths`` as device tensors, checked against the buffers' sizes where on the host."""
    return as_lengths(lengths, preceding.device, (preceding.shape[1], T, following.shape[1]))


def _weights(T: int, lengths, like: torch.Tensor) -> torch.Tensor:
    """The backward stream's per-step weight ``[T]``: ``time_weights``, or its
    masked form at the sampled T."""
    if lengths is None:
        return time_weights(T, like.dtype, like.device)
    return dynamic_time_weights(lengths[1], T, like.dtype)


class _MCNetModel(nn.Module):
    """A model built on one MC-Net (``mcnet``)."""

    def __init__(self, gf_dim: int, c_dim: int, feature_size: int = 3, forget_bias: float = 1.0,
                 remat: bool = False, scan_rollout: bool = False):
        super().__init__()
        del scan_rollout  # vfi_tpu's compile-time form of the same rollout
        self.gf_dim, self.c_dim = gf_dim, c_dim
        self.mcnet = MCNet(gf_dim, c_dim, feature_size, forget_bias, remat=remat)


class BidirectionalMCNetModel(_MCNetModel):
    """MC-Net forward from the preceding frames and backward from the
    time-reversed following frames."""

    def bidirectional_rollout(self, T: int, preceding, following, lengths=None) -> tuple[RolloutStep, RolloutStep]:
        """Both rollouts, time-major NCHW; the backward one back in natural time
        order.  With ``lengths`` (device tensors), each stream skips its
        buffer's invalid warm-up steps and the backward one is returned in
        rollout order (``reverse_middle`` at the sampled T puts it back)."""
        B, max_K = preceding.shape[:2]
        max_F = following.shape[1]
        xt, xt_b = preceding[:, -1], following[:, 0]
        diff_f = _diff_frames(preceding)
        diff_b = _diff_frames(following.flip(1))
        skip_f = skip_b = None
        if lengths is not None:
            skip_f = (max_K - lengths[0]).expand(B)
            skip_b = (max_F - lengths[2]).expand(B)
        if max_K == max_F:
            skip = None if lengths is None else torch.cat([skip_f, skip_b])
            out = self.mcnet(T, torch.cat([diff_f, diff_b]), torch.cat([xt, xt_b]), warmup_skip=skip)
            fwd = RolloutStep(*(a[:, :B] for a in out))
            bwd = RolloutStep(*(a[:, B:] for a in out))
        else:
            fwd = self.mcnet(T, diff_f, xt, warmup_skip=skip_f)
            bwd = self.mcnet(T, diff_b, xt_b, warmup_skip=skip_b)
        if lengths is None:
            return fwd, RolloutStep(*(a.flip(0) for a in bwd))
        return fwd, bwd

    def _rollouts(self, T: int, preceding, following, lengths):
        """(lengths as device tensors or None, forward stream, backward stream
        in natural middle order)."""
        if lengths is not None:
            lengths = _lengths(lengths, T, preceding, following)
        fwd, bwd = self.bidirectional_rollout(T, preceding, following, lengths)
        if lengths is not None:
            bwd = RolloutStep(*(reverse_middle(a, lengths[1]) for a in bwd))
        return lengths, fwd, bwd


class TAIFillInModel(BidirectionalMCNetModel):
    """bi-TAI: bidirectional MC-Net + time-aware adaptive-kernel blending.

    ``sepconv_impl`` is vfi_tpu's field of that name: :func:`sepconv`'s
    ``impl`` for the kernel net (None: the device's default; it holds no
    weights).
    """

    use_ratio = True

    def __init__(self, gf_dim: int, c_dim: int, feature_size: int = 3, forget_bias: float = 1.0,
                 remat: bool = False, scan_rollout: bool = False, ks: int = 51, num_block: int = 5,
                 kf_dim: int = 32, layers: int = 3, align_corners: bool = True, sepconv_impl: Optional[str] = None):
        super().__init__(gf_dim, c_dim, feature_size, forget_bias, remat, scan_rollout)
        self.merge_residual2 = Residual(gf_dim * 4, kf_dim * 2)
        self.merge_residual3 = Residual(gf_dim * 8, kf_dim * 4)
        self.kernelnet = KernelNet(gf_dim, ks, num_block, layers, kf_dim, use_ratio=self.use_ratio,
                                   align_corners=align_corners, sepconv_impl=sepconv_impl)

    def forward(self, T: int, preceding, following, lengths=None) -> Dict[str, torch.Tensor]:
        B = preceding.shape[0]
        lengths, fwd, bwd = self._rollouts(T, preceding, following, lengths)
        m2 = self.merge_residual2(_fold(fwd.res2), _fold(bwd.res2))
        m3 = self.merge_residual3(_fold(fwd.res3), _fold(bwd.res3))

        w = _weights(T, lengths, preceding)  # weight of the backward stream
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


class BidirectionalTimeWeightedAverageFillInModel(BidirectionalMCNetModel):
    """bi-TWA: the two streams' predictions averaged with time weights."""

    def forward(self, T: int, preceding, following, lengths=None) -> Dict[str, torch.Tensor]:
        lengths, fwd, bwd = self._rollouts(T, preceding, following, lengths)
        w = _weights(T, lengths, preceding)[:, None, None, None, None]
        comb = (1.0 - w) * fwd.pred + w * bwd.pred
        return {"pred": _video(comb), "pred_forward": _video(fwd.pred), "pred_backward": _video(bwd.pred)}


class BidirectionalSimpleAverageFillInModel(BidirectionalMCNetModel):
    """bi-SA: the plain 0.5/0.5 average of the two streams."""

    def forward(self, T: int, preceding, following, lengths=None) -> Dict[str, torch.Tensor]:
        _, fwd, bwd = self._rollouts(T, preceding, following, lengths)
        comb = 0.5 * fwd.pred + 0.5 * bwd.pred
        return {"pred": _video(comb), "pred_forward": _video(fwd.pred), "pred_backward": _video(bwd.pred)}


class MCNetFillInModel(_MCNetModel):
    """Forward-only baseline: MC-Net from the preceding frames alone."""

    def forward(self, T: int, preceding, following, lengths=None) -> Dict[str, torch.Tensor]:
        skip = None
        if lengths is not None:
            K = _lengths(lengths, T, preceding, following)[0]
            skip = (preceding.shape[1] - K).expand(preceding.shape[0])
        out = self.mcnet(T, _diff_frames(preceding), preceding[:, -1], warmup_skip=skip)
        return {"pred": _video(out.pred)}


class TimeWeightedPFFillInModel(nn.Module):
    """Parameter-free baseline: per-timestep weighted average of the last
    preceding and the first following frame."""

    def forward(self, T: int, preceding, following, lengths=None) -> Dict[str, torch.Tensor]:
        if lengths is not None:
            lengths = _lengths(lengths, T, preceding, following)
        w = _weights(T, lengths, preceding)[None, :, None, None, None]
        return {"pred": (1.0 - w) * preceding[:, -1:] + w * following[:, :1]}

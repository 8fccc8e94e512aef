"""Training losses (counterpart of ``vfi_tpu/train/losses.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gdl_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Image gradient-difference loss on ``[..., H, W, C]``.

    L1 between the spatial forward differences of pred and target, averaged
    over the interior (H-1) x (W-1) grid, as vfi_tpu crops it.
    """
    pw = pred[..., :, :-1, :] - pred[..., :, 1:, :]
    ph = pred[..., 1:, :, :] - pred[..., :-1, :, :]
    tw = target[..., :, :-1, :] - target[..., :, 1:, :]
    th = target[..., 1:, :, :] - target[..., :-1, :, :]
    w_term = (pw - tw).abs()[..., 1:, :, :]  # [..., H-1, W-1, C]
    h_term = (ph - th).abs()[..., :, 1:, :]
    return (w_term + h_term).mean()


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid cross-entropy, in the promoted dtype of the two (as jnp
    promotes bf16 logits against f32 labels)."""
    dt = torch.promote_types(logits.dtype, labels.dtype)
    return F.binary_cross_entropy_with_logits(logits.to(dt), labels.to(dt))


def disc_window_labels(K: int, T: int, F: int, window: int, device=None) -> torch.Tensor:
    """Labels of the sliding-window discriminator on a *fake* video: windows
    lying wholly inside the preceding or the following frames are real (1),
    every window touching a generated frame is fake (0).  ``[K+T+F-window+1]``."""
    idx = torch.arange(K + T + F - window + 1, device=device)
    return ((idx + window <= K) | (idx >= K + T)).float()

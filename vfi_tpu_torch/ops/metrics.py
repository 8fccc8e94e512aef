"""Batched PSNR / SSIM with scikit-image semantics (counterpart of
``vfi_tpu/ops/metrics.py``).

A whole ``[..., H, W, C]`` batch of frames is scored at once, in float32 on
the tensors' device.  Semantics are skimage's defaults on uint8 images:

  * PSNR: data_range=255, MSE in float.
  * SSIM: 7x7 uniform window over the valid region only, sample covariance
    (N/(N-1)), K1=.01, K2=.03, data_range=255; the mean over channels and
    valid pixels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .image import inverse_transform


def quantize_uint8(frames: torch.Tensor) -> torch.Tensor:
    """[-1, 1] frames -> float32 holding exact uint8 values [0, 255]: the
    clamp, scale and round of the predict CLI's PNG writes, so metrics on the
    device agree with metrics of the written PNGs."""
    x = torch.clamp(inverse_transform(frames.float()), 0.0, 1.0) * 255.0
    return torch.round(x)


def psnr(pred_u8: torch.Tensor, gt_u8: torch.Tensor, clamp: float | None = None) -> torch.Tensor:
    """PSNR per image over ``[..., H, W, C]`` uint8-valued tensors -> ``[...]``."""
    err = pred_u8.float() - gt_u8.float()
    mse = torch.mean(err**2, dim=(-3, -2, -1))
    p = 10.0 * torch.log10(255.0**2 / torch.clamp(mse, min=1e-12))
    if clamp is not None:
        # The summary tables clamp infinite and huge PSNR to 100.
        p = torch.clamp(p, max=clamp)
    return p


def ssim(pred_u8: torch.Tensor, gt_u8: torch.Tensor, win: int = 7) -> torch.Tensor:
    """SSIM per image over ``[..., H, W, C]`` uint8-valued tensors -> ``[...]``."""
    lead = pred_u8.shape[:-3]
    H, W, C = pred_u8.shape[-3:]
    x = pred_u8.float().reshape(-1, H, W, C).permute(0, 3, 1, 2)  # [N, C, H, W]
    y = gt_u8.float().reshape(-1, H, W, C).permute(0, 3, 1, 2)

    def win_mean(a):  # the uniform filter over VALID windows
        return F.avg_pool2d(a, win, stride=1)

    n = win * win
    cov_norm = n / (n - 1)  # sample covariance, skimage's default
    ux, uy = win_mean(x), win_mean(y)
    uxx, uyy, uxy = win_mean(x * x), win_mean(y * y), win_mean(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (0.01 * 255.0) ** 2
    c2 = (0.03 * 255.0) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
    return s.mean(dim=(1, 2, 3)).reshape(lead)

"""Spectral-normalized sliding-window video discriminator (counterpart of
``vfi_tpu/nn/discriminator.py``).

Four stride-2 SN convs and an SN linear head score every ``window_size``-frame
window of a video, frames stacked on channels t-major.  As in vfi_tpu:

  * the power-iteration vector ``u`` is a buffer (vfi_tpu's ``"sn"``
    collection), written only when ``train=True``;
  * the weight is normalized on the fly, ``w / sigma``; the stored weight is
    never divided, and sigma carries no gradient (``stop_gradient``);
  * the power iteration runs in float32 on the weight as given (bf16 under
    mixed precision), and the division keeps the weight's dtype;
  * the head always uses one power iteration, whatever ``Ip``;
  * features are flattened in NHWC order (h, w, c) before the head, so the
    head's weight is vfi_tpu's kernel transposed.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _l2normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.sqrt(torch.sum(v**2)) + eps)


class SpectralNorm(nn.Module):
    """``w / sigma_max(w)`` with the power-iteration state ``u`` (a buffer of
    ``out_features``).  Rows of ``w.reshape(out, -1)`` are output features;
    its column order differs from vfi_tpu's HWIO flattening, which leaves
    u and sigma unchanged."""

    def __init__(self, out_features: int, n_power_iterations: int = 1):
        super().__init__()
        self.n_power_iterations = n_power_iterations
        self.register_buffer("u", torch.randn(out_features))

    def forward(self, w: torch.Tensor, train: bool) -> torch.Tensor:
        with torch.no_grad():
            w_mat = w.reshape(w.shape[0], -1).float()  # [out, in*k*k]
            u = self.u.float()
            for _ in range(self.n_power_iterations):
                v = _l2normalize(u @ w_mat)
                u = _l2normalize(w_mat @ v)
            sigma = u @ w_mat @ v
            if train:
                self.u.copy_(u)
        return w / sigma.to(w.dtype)


class SNConv(nn.Module):
    """k4 / s2 / p1 conv with a spectrally normalized weight."""

    def __init__(self, in_features: int, features: int, kernel: int = 4, stride: int = 2, Ip: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        nn.init.xavier_normal_(self.weight)
        self.sn = SpectralNorm(features, Ip)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return F.conv2d(x, self.sn(self.weight, train), self.bias, stride=self.stride, padding=1)


class SNDense(nn.Module):
    """Linear layer with a spectrally normalized weight; uniform [0, 0.02] init
    (the reference's linear init)."""

    def __init__(self, in_features: int, features: int, Ip: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features).uniform_(0.0, 0.02))
        self.bias = nn.Parameter(torch.zeros(features))
        self.sn = SpectralNorm(features, Ip)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return F.linear(x, self.sn(self.weight, train), self.bias)


class SNDiscriminator(nn.Module):
    """Sliding-window video discriminator.

    Input: video ``[B, Ttot, H, W, C]``; output: logits ``[B, Ttot - window_size + 1]``.

    :param image_size: (H, W) of the frames; fixes the head's input width.
    """

    def __init__(self, window_size: int, c_dim: int, image_size: Tuple[int, int], df_dim: int = 64,
                 Ip: int = 1):
        super().__init__()
        self.window_size = window_size
        h, w = image_size
        c = window_size * c_dim
        for i, mult in enumerate((1, 2, 4, 8)):
            self.add_module(f"conv{i}", SNConv(c, df_dim * mult, Ip=Ip))
            c = df_dim * mult
            h, w = (h - 2) // 2 + 1, (w - 2) // 2 + 1  # k4, s2, p1
        self.head = SNDense(c * h * w, 1, Ip=1)

    def forward(self, video: torch.Tensor, train: bool = True) -> torch.Tensor:
        B, Ttot, H, W, C = video.shape
        w = self.window_size
        nw = Ttot - w + 1
        windows = torch.stack([video[:, s : s + w] for s in range(nw)], dim=1)  # [B, nw, w, H, W, C]
        x = windows.permute(0, 1, 2, 5, 3, 4).reshape(B * nw, w * C, H, W)  # channel t*C + c
        for i in range(4):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x, train), 0.2)
        x = x.permute(0, 2, 3, 1).reshape(B * nw, -1)
        return self.head(x, train).reshape(B, nw)

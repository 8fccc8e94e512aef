"""Shared layers (counterpart of ``vfi_tpu/nn/layers.py``), NCHW.

Every conv is 'same'-padded with xavier-normal weights and zero bias, the
reference's init.  Submodules carry vfi_tpu's flax names, so a flax path maps
to a state_dict key mechanically (``vfi_tpu_torch/utils/params.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv(nn.Conv2d):
    """Stride-1 'same' conv with xavier-normal weights and zero bias."""

    def __init__(self, in_features: int, features: int, kernel: int):
        super().__init__(in_features, features, kernel, padding=kernel // 2)

    def reset_parameters(self) -> None:
        nn.init.xavier_normal_(self.weight)
        nn.init.zeros_(self.bias)


class _MaxPool2TieSplit(torch.autograd.Function):
    """``F.max_pool2d(x, 2)`` whose gradient splits a tie evenly among the tied
    elements of a window (vfi_tpu's reduce-max gradient), where
    ``F.max_pool2d`` routes it all to the first argmax.  The forward is
    PyTorch's pooling kernel: reshape + ``amax`` gives the same gradient but
    its forward is 3x slower on an H100 (PERF.md)."""

    @staticmethod
    def forward(ctx, x):
        out = F.max_pool2d(x, 2)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        B, C, H, W = x.shape
        # 1 where an element ties its window's max.  The count per window (<= 4)
        # is 4x its 2x2 mean, exact in g's dtype; PyTorch's pooling kernel
        # takes it faster than a reduction over the two size-2 axes.
        tied = (x.reshape(B, C, H // 2, 2, W // 2, 2) == out[:, :, :, None, :, None]).to(g.dtype)
        count = F.avg_pool2d(tied.reshape(B, C, H, W), 2) * 4
        return (tied * (g / count)[:, :, :, None, :, None]).reshape(B, C, H, W)


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 max pool.  Even extents split a tied window's gradient
    evenly, as vfi_tpu does; odd extents keep ``F.max_pool2d``, as vfi_tpu
    keeps its windowed pool there."""
    if x.shape[-2] % 2 or x.shape[-1] % 2:
        return F.max_pool2d(x, 2)
    return _MaxPool2TieSplit.apply(x)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 average pool."""
    return F.avg_pool2d(x, 2)


class ConvBlock(nn.Module):
    """``num_layers`` x (conv -> relu), named ``conv0 ..``; the first maps
    ``in_features`` to ``features``."""

    def __init__(self, in_features: int, features: int, num_layers: int, kernel: int = 3):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"conv{i}", Conv(in_features if i == 0 else features, features, kernel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return x


class ConvLSTMCell(nn.Module):
    """Convolutional LSTM cell with a forget-gate bias.

    The state is one tensor ``[B, 2*features, H, W]`` holding (c, h) on the
    channel axis.  Gates come from a conv over ``[x, h]`` and split i, j, f, o.
    """

    def __init__(self, in_features: int, features: int, kernel: int = 3, forget_bias: float = 1.0):
        super().__init__()
        self.features = features
        self.forget_bias = forget_bias
        self.gates = Conv(in_features + features, 4 * features, kernel)

    def forward(self, x: torch.Tensor, state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        c, h = torch.chunk(state, 2, dim=1)
        i, j, f, o = torch.chunk(self.gates(torch.cat([x, h], dim=1)), 4, dim=1)
        new_c = c * torch.sigmoid(f + self.forget_bias) + torch.sigmoid(i) * torch.tanh(j)
        new_h = torch.tanh(new_c) * torch.sigmoid(o)
        return new_h, torch.cat([new_c, new_h], dim=1)

    @staticmethod
    def initial_state(batch: int, height: int, width: int, features: int, dtype=torch.float32,
                      device=None) -> torch.Tensor:
        return torch.zeros((batch, 2 * features, height, width), dtype=dtype, device=device)

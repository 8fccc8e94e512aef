"""Plain layers of the reference: NCHW convs in a chosen precision, pooling,
unpooling, the corner-aligned bilinear upsample and the ConvLSTM cell.

A reference model computes in float32.  Its convs can be put into a lower
precision for the benchmark's controls (:func:`set_precision`): static
symmetric int8 or int4 (per-output-channel weight scales, one activation
scale per conv recorded by :func:`calibrate` as a running max of ``|x|``,
sums and scales in float32, the output in the input's dtype),
or fp8 operands (e4m3 forward, e5m2 gradients, per-tensor scales) with
float32 sums.
"""

from __future__ import annotations

import contextlib
import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

LEVELS = {"int8": 127, "int4": 7}
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


# A conv's precision: "float32" (the model's dtype), "int8", "int4" or "fp8".
PRECISIONS = ("float32", "int8", "int4", "fp8")


def _fp8_round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` through ``dtype`` with a per-tensor scale that maps its amax to the format's largest value."""
    scale = torch.clamp_min(x.detach().abs().amax().float() / FP8_MAX[dtype], 1e-30)
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g, torch.float8_e5m2)


class Conv(nn.Module):
    """Stride-1 'same' conv (``weight [out, in, k, k]``, ``bias [out]``)."""

    def __init__(self, in_features: int, features: int, kernel: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(features))
        self.precision = "float32"
        self.calibrating = False
        self.register_buffer("act_amax", torch.zeros(()), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        kind = self.precision
        if kind == "float32":
            return F.conv2d(x, self.weight, self.bias, padding=k // 2)
        if kind == "fp8":
            return F.conv2d(_Fp8.apply(x), _Fp8.apply(self.weight), self.bias, padding=k // 2)
        levels = LEVELS[kind]
        if self.calibrating:
            self.act_amax = torch.maximum(self.act_amax, x.detach().abs().amax().float())
        sx = torch.clamp_min(self.act_amax / levels, 1e-12)
        w = self.weight.detach().float()
        sw = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)) / levels, 1e-12)
        xq = torch.clamp(torch.round(x.float() / sx), -levels, levels)
        wq = torch.clamp(torch.round(w / sw[:, None, None, None]), -levels, levels)
        acc = F.conv2d(xq, wq, padding=k // 2)
        # Scales and sums in float32, the output in the input's dtype.
        return (acc * (sx * sw)[None, :, None, None] + self.bias.float()[None, :, None, None]).to(x.dtype)


def convs(module: nn.Module):
    """Every reference ``Conv`` under ``module``."""
    return [m for m in module.modules() if isinstance(m, Conv)]


def set_precision(module: nn.Module, kind: str) -> nn.Module:
    if kind not in PRECISIONS:
        raise ValueError(f"unknown precision {kind!r}; one of {PRECISIONS}")
    for m in convs(module):
        m.precision = kind
    return module


@contextlib.contextmanager
def calibrate(module: nn.Module):
    """Inside, every int-quantized conv records the running max of its input's ``|x|``, from zero."""
    cs = convs(module)
    for m in cs:
        m.act_amax = torch.zeros((), device=m.weight.device)
        m.calibrating = True
    try:
        yield module
    finally:
        for m in cs:
            m.calibrating = False


class _MaxPool2TieSplit(torch.autograd.Function):
    """2x2 max pool whose gradient splits a tie evenly among the tied elements."""

    @staticmethod
    def forward(ctx, x):
        out = F.max_pool2d(x, 2)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        B, C, H, W = x.shape
        tied = (x.reshape(B, C, H // 2, 2, W // 2, 2) == out[:, :, :, None, :, None]).to(g.dtype)
        count = tied.sum(dim=(3, 5), keepdim=True)
        return (tied * g[:, :, :, None, :, None] / count).reshape(B, C, H, W)


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    if x.shape[-2] % 2 or x.shape[-1] % 2:
        return F.max_pool2d(x, 2)
    return _MaxPool2TieSplit.apply(x)


def fixed_unpooling(x: torch.Tensor) -> torch.Tensor:
    """Zero-stuffing 2x upsample: ``out[2y, 2x] = in[y, x]``, zeros elsewhere."""
    B, C, H, W = x.shape
    out = x.new_zeros((B, C, 2 * H, 2 * W))
    out[:, :, ::2, ::2] = x
    return out


def _corner_matrix(n: int, like: torch.Tensor) -> torch.Tensor:
    """``[2n, n]`` linear interpolation, output i at input i*(n-1)/(2n-1)."""
    out = np.zeros((2 * n, n))
    if n == 1:
        out[:, 0] = 1.0
    else:
        pos = np.arange(2 * n) * (n - 1) / (2 * n - 1)
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(lo + 1, n - 1)
        out[np.arange(2 * n), lo] += 1.0 - (pos - lo)
        out[np.arange(2 * n), hi] += pos - lo
    return torch.as_tensor(out, dtype=like.dtype, device=like.device)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """Corner-aligned bilinear 2x upsample of ``[B, C, H, W]``."""
    return _corner_matrix(x.shape[-2], x) @ x @ _corner_matrix(x.shape[-1], x).T


BGR_LUMA = (0.1140, 0.5870, 0.2989)


def to_gray_frames(frames: torch.Tensor) -> torch.Tensor:
    """Channels-last [-1, 1] frames -> [0, 1] luma of BGR channels."""
    f01 = (frames + 1.0) / 2.0
    if frames.shape[-1] == 1:
        return f01
    return (f01 * torch.tensor(BGR_LUMA, dtype=f01.dtype, device=f01.device)).sum(-1, keepdim=True)


class ConvLSTMCell(nn.Module):
    """State ``[B, 2F, H, W]`` holds (c, h); gates i, j, f, o from a conv over ``[x, h]``."""

    def __init__(self, in_features: int, features: int, kernel: int = 3, forget_bias: float = 1.0):
        super().__init__()
        self.features = features
        self.forget_bias = forget_bias
        self.gates = Conv(in_features + features, 4 * features, kernel)

    def forward(self, x, state):
        c, h = torch.chunk(state, 2, dim=1)
        i, j, f, o = torch.chunk(self.gates(torch.cat([x, h], dim=1)), 4, dim=1)
        new_c = c * torch.sigmoid(f + self.forget_bias) + torch.sigmoid(i) * torch.tanh(j)
        new_h = torch.tanh(new_c) * torch.sigmoid(o)
        return new_h, torch.cat([new_c, new_h], dim=1)

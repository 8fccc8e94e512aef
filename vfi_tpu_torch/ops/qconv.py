"""int8 serving convolution: the activation quantize and the int8 conv
(the work XLA does for vfi_tpu's int8 mode, ``vfi_tpu/nn/quant.py:101-123``).

Each is a plain PyTorch version beside a hand-written CUDA kernel
(``csrc/qconv_int8.cu``) that is held against it:

  * :func:`quantize_int8_plain` / :func:`quantize_int8_cuda`: NCHW float32
    or bfloat16 in, NHWC int8 out with the channels zero-padded to a multiple
    of 32 (:func:`padded_channels`), ``clamp(round(x / scale), -127, 127)``
    with the scale a float32 scalar tensor on the input's device.
  * :func:`qconv_int8_plain` / :func:`qconv_int8_cuda`: stride 1, 'same'
    padding, odd k up to 7: ``xq [N, H, W, Cp]`` int8 and ``wq [Co, k, k, Cp]``
    int8 give the int32 sums ``[N, Co, H, W]``; with a float ``out_dtype``
    they are dequantized as ``(float(acc) * scale[c] + bias[c])`` in float32,
    ``scale[c]`` being ``x_scale * w_scale[c]``, and cast to ``out_dtype``.

:func:`quantize_int8` and :func:`qconv_int8` take the plain versions for CPU
tensors and the kernels for CUDA tensors, which launch or raise: no CUDA call
falls back to the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

CHUNK = 32  # the conv kernel's K granule: input channels per mma.sync m16n8k32
KERNEL_SIZES = (1, 3, 5, 7)

# Launches of each CUDA kernel; each is incremented by its wrapper only.
quantize_int8_launches = 0
qconv_int8_launches = 0

_OUT_CODE = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}


def padded_channels(c: int) -> int:
    return -(-c // CHUNK) * CHUNK


def quantize_int8_plain(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clamp(round(x / scale), -127, 127)`` in float32 (IEEE division, half
    to even), NCHW -> NHWC int8 with zero-padded channels."""
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8).permute(0, 2, 3, 1)
    return F.pad(q, (0, padded_channels(q.shape[-1]) - q.shape[-1])).contiguous()


def qconv_int8_plain(xq: torch.Tensor, wq: torch.Tensor, scale: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """The int8 conv as ``F.conv2d`` on float64 copies of the int8 values:
    exact, since every partial sum is an integer below 127^2 * k*k * Cp < 2^53.
    cuDNN is kept out (its FFT and Winograd algorithms would round)."""
    k = wq.shape[1]
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.permute(0, 3, 1, 2).double(), padding=k // 2)
    acc = acc.to(torch.int32)
    if out_dtype == torch.int32:
        return acc
    y = acc.float() * scale.float()[None, :, None, None] + bias.float()[None, :, None, None]
    return y.to(out_dtype)


def _check_cuda(fn: str, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{fn} needs CUDA tensors; {name} is on {t.device}")
    if len({t.device for t in tensors.values()}) != 1:
        raise ValueError(f"{fn}: operands on different devices: {[str(t.device) for t in tensors.values()]}")


def quantize_int8_cuda(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch the quantize kernel: x ``[N, C, H, W]`` float32 or bfloat16 (any
    strides), scale a float32 scalar on the same card -> ``[N, H, W, Cp]`` int8."""
    global quantize_int8_launches
    from . import _kernels

    _check_cuda("quantize_int8_cuda", x=x, scale=scale)
    if x.ndim != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quantize_int8_cuda takes NCHW float32 or bfloat16; got {tuple(x.shape)} {x.dtype}")
    if scale.numel() != 1 or scale.dtype != torch.float32:
        raise ValueError(f"quantize_int8_cuda takes a float32 scalar scale; got {tuple(scale.shape)} {scale.dtype}")
    N, C, H, W = x.shape
    Cp = padded_channels(C)
    out = torch.empty((N, H, W, Cp), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        _kernels.qconv_launch("quantize_int8", x.data_ptr(), scale.data_ptr(), out.data_ptr(), *x.stride(),
                              N, C, H, W, Cp, 0 if x.dtype == torch.float32 else 1)
    quantize_int8_launches += 1
    return out


def qconv_int8_cuda(xq: torch.Tensor, wq: torch.Tensor, scale: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Launch the int8 conv kernel: ``xq [N, H, W, Cp]`` and ``wq [Co, k, k,
    Cp]`` int8, contiguous; ``scale`` and ``bias`` ``[Co]`` float32 for a float
    ``out_dtype`` -> ``[N, Co, H, W]`` in ``out_dtype``."""
    global qconv_int8_launches
    from . import _kernels

    _check_cuda("qconv_int8_cuda", xq=xq, wq=wq)
    if xq.ndim != 4 or wq.ndim != 4 or xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"qconv_int8_cuda takes rank-4 int8 operands; got xq {tuple(xq.shape)} {xq.dtype}, "
                         f"wq {tuple(wq.shape)} {wq.dtype}")
    N, H, W, Cp = xq.shape
    Co, k, k2, wcp = wq.shape
    if k != k2 or k not in KERNEL_SIZES or wcp != Cp or Cp % CHUNK:
        raise ValueError(f"qconv_int8_cuda takes square odd k in {KERNEL_SIZES} and Cp a multiple of {CHUNK} "
                         f"on both operands; got xq {tuple(xq.shape)}, wq {tuple(wq.shape)}")
    if not (xq.is_contiguous() and wq.is_contiguous()):
        raise ValueError("qconv_int8_cuda takes contiguous xq and wq")
    if out_dtype not in _OUT_CODE:
        raise ValueError(f"qconv_int8_cuda writes int32, float32 or bfloat16; got {out_dtype}")
    ptrs = (0, 0)
    if out_dtype != torch.int32:
        for name, t in (("scale", scale), ("bias", bias)):
            if t is None or t.dtype != torch.float32 or t.shape != (Co,) or not t.is_contiguous():
                raise ValueError(f"qconv_int8_cuda: {name} must be a contiguous float32 [{Co}] tensor")
            _check_cuda("qconv_int8_cuda", xq=xq, **{name: t})
        ptrs = (scale.data_ptr(), bias.data_ptr())
    out = torch.empty((N, Co, H, W), dtype=out_dtype, device=xq.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(xq.device):
        _kernels.qconv_launch("qconv_int8", xq.data_ptr(), wq.data_ptr(), *ptrs, out.data_ptr(), N, H, W, Cp, Co, k,
                              _OUT_CODE[out_dtype])
    qconv_int8_launches += 1
    return out


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """:func:`quantize_int8_plain` on CPU tensors, the kernel on CUDA tensors."""
    return (quantize_int8_plain if x.device.type == "cpu" else quantize_int8_cuda)(x, scale)


def qconv_int8(xq: torch.Tensor, wq: torch.Tensor, scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """:func:`qconv_int8_plain` on CPU tensors, the kernel on CUDA tensors."""
    return (qconv_int8_plain if xq.device.type == "cpu" else qconv_int8_cuda)(xq, wq, scale, bias, out_dtype)

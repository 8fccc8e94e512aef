"""Least times of the hand-written kernels' calls, from shapes: the larger of
the bytes each must move (every input read once, every output written once)
over the memory rate and the operations it must do over the compute rate.
Frozen copies of the port's bring-up bounds (``chip_smoke.py``'s
``sepconv_bound_ms``, ``sepconv_bwd_vh_bound_ms``, ``sepconv_bwd_x_bound_ms``,
``qconv_bound_ms``), in seconds and on shapes.

sepconv: ``x [B, H+ks-1, W+ks-1, C]``, ``v``, ``h [B, H, W, ks]``, ``g`` and
the output ``[B, H, W, C]``, all of one dtype of ``elem`` bytes, computed at
``ops_s`` (bf16 tensor cores, or float32 CUDA cores).
"""

from __future__ import annotations

from .peaks import Peak


def _bound(nbytes: float, ops: float, ops_s: float, peak: Peak) -> float:
    return max(nbytes / peak.bytes_s, ops / ops_s)


def _ops_s(elem: int, peak: Peak) -> float:
    return peak.bf16 if elem == 2 else peak.f32


def sepconv_fwd_s(B, H, W, C, ks, elem, peak: Peak) -> float:
    """Reads x, v, h, writes out; 2*ks*(ks+1) flops per output pixel and channel."""
    x = B * (H + ks - 1) * (W + ks - 1) * C
    nbytes = (x + 2 * B * H * W * ks + B * H * W * C) * elem
    return _bound(nbytes, 2 * ks * (ks + 1) * B * H * W * C, _ops_s(elem, peak), peak)


def sepconv_bwd_vh_s(B, H, W, C, ks, elem, peak: Peak) -> float:
    """Reads x, v, h, g, writes grad_v, grad_h; 4*ks*(ks+1) flops per output pixel and channel."""
    x = B * (H + ks - 1) * (W + ks - 1) * C
    nbytes = (x + 4 * B * H * W * ks + B * H * W * C) * elem
    return _bound(nbytes, 4 * ks * (ks + 1) * B * H * W * C, _ops_s(elem, peak), peak)


def sepconv_bwd_x_s(B, H, W, C, ks, elem, peak: Peak) -> float:
    """Reads v, h, g, writes grad_x; ks*(2*ks+1) flops per output pixel and channel."""
    nbytes = (2 * B * H * W * ks + B * H * W * C + B * (H + ks - 1) * (W + ks - 1) * C) * elem
    return _bound(nbytes, ks * (2 * ks + 1) * B * H * W * C, _ops_s(elem, peak), peak)


def padded_channels(c: int) -> int:
    return -(-c // 32) * 32


def qconv_s(images, cin, cout, k, h, w, in_bytes, out_bytes, peak: Peak) -> float:
    """The fused int8 conv: x (its dtype, unpadded channels), the int8 weights
    (channels padded to 32) and the output once; or 2 * MAC at the int8 rate."""
    nbytes = images * cin * h * w * in_bytes + cout * k * k * padded_channels(cin) + images * cout * h * w * out_bytes
    return max(nbytes / peak.bytes_s, 2 * images * h * w * cout * cin * k * k / peak.int8)

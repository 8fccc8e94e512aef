"""int8 serving convolution: the activation quantize and the int8 conv
(the work XLA does for vfi_tpu's int8 mode, ``vfi_tpu/nn/quant.py:96-123``),
fused into one hand-written CUDA kernel (``csrc/qconv_int8.cu``):

  * :func:`quantize_int8_plain`: NCHW float32 or bfloat16 in, NHWC int8 out
    with the channels zero-padded to a multiple of 32
    (:func:`padded_channels`), ``clamp(round(x / scale), -127, 127)`` with
    the scale a float32 scalar tensor on the input's device.
  * :func:`qconv_int8_plain`: stride 1, 'same' padding, odd k up to 7:
    ``xq [N, H, W, Cp]`` int8 and ``wq [Co, k, k, Cp]`` int8 give the int32
    sums ``[N, Co, H, W]``; with a float ``out_dtype`` they are dequantized as
    ``(float(acc) * scale[c] + bias[c])`` in float32, ``scale[c]`` being
    ``x_scale * w_scale[c]``, and cast to ``out_dtype``.
  * :func:`qconv_int8_cuda`: the kernel, which computes
    ``qconv_int8_plain(quantize_int8_plain(x, x_scale), wq, ...)`` in one
    launch from x as it is (any strides): the int8 activation never lands in
    device memory.  It takes the weights repacked by :func:`pack_weight` for
    the N tile :func:`n_tile`.
  * :func:`qconv_int8_tiled`: a torch emulation of the kernel's addressing
    (tile choice, halo layout, descriptor shifts, weight stages, edge
    masks) and of its quantize arithmetic (:func:`quantize_staged`), for the
    CPU tests.

:func:`qconv_int8` takes the plain versions for CPU tensors and the kernel
for CUDA tensors, which launches or raises: no CUDA call falls back to the
plain version.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

CHUNK = 32  # the conv kernel's K granule: input channels per wgmma m64nNk32 s8
KERNEL_SIZES = (1, 3, 5, 7)
# The kernel's tiling (csrc/qconv_int8.cu), copied for the emulation and its
# test (the kernel chooses its own ring depth): m64 tiles of TILE x TILE
# output pixels, CONSUMERS warpgroups a block, the N tiles it is built for,
# the epilogue's channels per pass, the weight ring's stages and shared memory.
TILE = 8
CONSUMERS = 2
N_TILES = (8, 32, 64, 128, 256)
EPI_CH = 32
MAX_DEPTH = 4
BAR_BYTES = 128
SMEM_MAX = 232448
# The kernel's quantize (quantize_fast): 1.5 * 2^23, and how far from a
# half-integer r = x * fl(1/s) must lie to round as fl(x / s) does.
ROUND = torch.tensor(12582912.0, dtype=torch.float32)
NEAR_HALF = torch.tensor(0.49996, dtype=torch.float32)

# Launches of the CUDA kernel, incremented by its wrapper only.
qconv_int8_launches = 0

_OUT_CODE = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}
_IN_CODE = {torch.float32: 0, torch.bfloat16: 1}


def padded_channels(c: int) -> int:
    return -(-c // CHUNK) * CHUNK


def quantize_int8_plain(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clamp(round(x / scale), -127, 127)`` in float32 (IEEE division, half
    to even), NCHW -> NHWC int8 with zero-padded channels."""
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8).permute(0, 2, 3, 1)
    return F.pad(q, (0, padded_channels(q.shape[-1]) - q.shape[-1])).contiguous()


def quantize_fast(v: torch.Tensor, inv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's ``quantize_fast`` on float32 ``v``: ``r = clamp(v * inv,
    -127, 127)`` rounded half to even by adding 1.5 * 2^23, whose float holds
    the int8 byte in its low byte; and the values it flags (``r`` within 4e-5
    of a half-integer), which the kernel redoes by division."""
    r = torch.clamp(v * inv, -127, 127)
    t = r + ROUND
    near = (r - (t - ROUND)).abs() > NEAR_HALF
    return (t.view(torch.int32) & 0xFF).to(torch.uint8).view(torch.int8), near


def quantize_staged(v: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """The bytes the kernel stages for values ``v`` (any shape, float32 or
    bfloat16): :func:`quantize_fast` with ``fl(1 / x_scale)``, the flagged
    values, and all of them where that reciprocal is not a normal float32,
    redone as ``clamp(round(v / x_scale), -127, 127)``."""
    v, s = v.float(), x_scale.float().reshape(())
    inv = torch.reciprocal(s)
    q, near = quantize_fast(v, inv)
    if not bool((inv >= torch.finfo(torch.float32).tiny) & (inv <= torch.finfo(torch.float32).max)):
        near = torch.ones_like(near)
    return torch.where(near, torch.clamp(torch.round(v / s), -127, 127).to(torch.int8), q)


def dequantize_plain(acc: torch.Tensor, scale, bias, out_dtype: torch.dtype) -> torch.Tensor:
    """The epilogue: int32 sums as they are, or ``float(acc) * scale[c] +
    bias[c]`` in float32 (two roundings) cast to ``out_dtype``."""
    if out_dtype == torch.int32:
        return acc
    y = acc.float() * scale.float()[None, :, None, None] + bias.float()[None, :, None, None]
    return y.to(out_dtype)


def qconv_int8_plain(xq: torch.Tensor, wq: torch.Tensor, scale: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """The int8 conv as ``F.conv2d`` on float64 copies of the int8 values:
    exact, since every partial sum is an integer below 127^2 * k*k * Cp < 2^53.
    cuDNN is kept out (its FFT and Winograd algorithms would round)."""
    k = wq.shape[1]
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.permute(0, 3, 1, 2).double(), padding=k // 2)
    return dequantize_plain(acc.to(torch.int32), scale, bias, out_dtype)


def n_tile(co: int) -> int:
    """The kernel's N tile for ``co`` output channels: the smallest it is
    built for that covers them, 256 above."""
    return next(n for n in N_TILES if n >= min(co, N_TILES[-1]))


def qconv_tiles(H: int, W: int, Cp: int, Co: int, k: int) -> dict:
    """The kernel's tiling of one conv shape: the N tile ``bn``, m64 tiles a
    warpgroup ``mt``, the weight ring's ``depth`` (as many stages of one
    kernel row as fit, at most 4, as the kernel's launch chooses it), the
    halo's width and positions, the grid and the shared-memory layout (the
    kernel's ``layout``)."""
    bn = n_tile(Co)
    mt = 1 if bn == 256 else 2
    cg = min(bn, EPI_CH)
    halo_w = TILE + k - 1
    halo = halo_w * halo_w
    stage = k * bn * CHUNK
    tile = 2 * halo * 16
    a = 2 * CONSUMERS * mt * tile  # each warpgroup's two halo buffers
    epi = CONSUMERS * cg * (64 * mt + 4) * 4
    depth = min(MAX_DEPTH, (SMEM_MAX - BAR_BYTES - a - epi) // stage)
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    co_pad = -(-Co // bn) * bn
    return dict(bn=bn, mt=mt, depth=depth, halo_w=halo_w, halo=halo, tile=tile,
                smem=BAR_BYTES + depth * stage + a + epi, tiles_x=tiles_x, tiles_y=tiles_y, co_pad=co_pad,
                n_tiles=co_pad // bn, chunks=Cp // CHUNK)


def pack_weight(wq: torch.Tensor, bn: int) -> torch.Tensor:
    """``wq [Co, k, k, Cp]`` int8 -> ``[Cp/32, k*k, Co_pad/8, 2, 8, 16]``, Co
    zero-padded to a multiple of ``bn``: the weights of one tap and N tile
    are one run of ``bn * 32`` bytes in wgmma's core-matrix order (8 output
    channels x 16 bytes of K, the two 16-byte k-halves 128 bytes apart)."""
    co, k, _, cp = wq.shape
    co_pad = -(-co // bn) * bn
    w = F.pad(wq.reshape(co, k * k, cp), (0, 0, 0, 0, 0, co_pad - co))
    return w.reshape(co_pad // 8, 8, k * k, cp // CHUNK, 2, 16).permute(3, 2, 0, 4, 1, 5).contiguous()


def _descriptor_view(smem: torch.Tensor, start: int, rows: int, lbo: int, sbo: int, taps: int,
                     tap_shift: int) -> torch.Tensor:
    """What ``taps`` no-swizzle K-major wgmma descriptors read from ``smem
    [..., bytes]`` (one element a byte), the j-th starting at ``start + j *
    tap_shift``: ``[..., rows, taps * 32]``, row r and K byte kk of tap j at
    ``start + j * tap_shift + (r // 8) * SBO + (r % 8) * 16 + (kk // 16) *
    LBO + kk % 16`` (8-row core matrices of 16-byte rows)."""
    lead = smem.shape[:-1]
    size = (*lead, rows // 8, 8, taps, 2, 16)
    stride = (*smem.stride()[:-1], sbo, 16, tap_shift, lbo, 1)
    return smem.as_strided(size, stride, smem.storage_offset() + start).reshape(*lead, rows, taps * CHUNK)


def qconv_int8_tiled(x: torch.Tensor, x_scale: torch.Tensor, wq: torch.Tensor, scale: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """The kernel's computation by its own addressing, in torch (CPU).

    Per m64 tile (8 x 8 output pixels of one image, in the kernel's order)
    and 32-channel chunk, the halo is staged byte for byte as the kernel
    stages it, ``[k-half][halo row][halo col][16 B]``, quantized from x by
    the kernel's arithmetic (:func:`quantize_staged`; its vector and element
    load paths give the same bytes); each tap
    reads its A operand through its descriptor (start shifted by ``(ky *
    halo_w + kx) * 16``, SBO one halo row, LBO one k-half); the weights of
    each (chunk, kernel row, N tile) stage are copied from
    :func:`pack_weight`'s layout as the producer thread copies them and read
    through B's descriptors (LBO 128, SBO 256); each stage's products are
    exact in float32 and summed in int32; outputs past the map, and channels
    past Co, are dropped."""
    N, C, H, W = x.shape
    Co, k, _, Cp = wq.shape
    t = qconv_tiles(H, W, Cp, Co, k)
    bn, hw, halo, pad, tile = t["bn"], t["halo_w"], t["halo"], k // 2, t["tile"]
    flat_w = pack_weight(wq, bn).reshape(-1)
    m = torch.arange(N * t["tiles_y"] * t["tiles_x"])
    tx, ty, tn = m % t["tiles_x"] * TILE, m // t["tiles_x"] % t["tiles_y"] * TILE, m // (t["tiles_x"] * t["tiles_y"])
    pos = torch.arange(halo)
    ys, xs = ty[:, None] - pad + pos // hw, tx[:, None] - pad + pos % hw
    inside = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
    # The quantize is elementwise: each value's byte, gathered into every halo that holds it.
    q = quantize_staged(x, x_scale)[tn[:, None], :, ys.clamp(0, H - 1), xs.clamp(0, W - 1)]  # [tiles, halo, C]
    q = q * inside[..., None]
    q = F.pad(q, (0, Cp - C)).reshape(len(m), halo, t["chunks"], 2, 16)
    halos = q.permute(0, 2, 3, 1, 4).reshape(len(m), t["chunks"], tile).float()  # each tile's staged bytes
    acc = torch.zeros(len(m), 64, t["co_pad"], dtype=torch.int32)
    for nt in range(t["n_tiles"]):
        for c in range(t["chunks"]):
            for ky in range(k):
                runs = [flat_w[((c * k + ky) * k + kx) * t["co_pad"] * CHUNK + nt * bn * CHUNK:][:bn * CHUNK]
                        for kx in range(k)]
                stage = torch.cat(runs).float()  # the ring stage the producer fills: k taps of one kernel row
                # Tap (ky, kx): A's start shifted by (ky * halo_w + kx) * 16, B's by kx * bn * 32.
                a = _descriptor_view(halos[:, c], ky * hw * 16, 64, halo * 16, hw * 16, k, 16)  # [tiles, 64, k * 32]
                b = _descriptor_view(stage, 0, bn, 128, 256, k, bn * CHUNK)  # [bn, k * 32]
                # One kernel row's products: at most 7 * 32 * 127^2 < 2^24, exact in float32.
                acc[:, :, nt * bn:(nt + 1) * bn] += (a @ b.T).to(torch.int32)
    # Row r of an m64 tile is pixel (r // 8, r % 8) of its 8 x 8 patch.
    acc = acc.reshape(N, t["tiles_y"], t["tiles_x"], TILE, TILE, t["co_pad"]).permute(0, 5, 1, 3, 2, 4)
    acc = acc.reshape(N, t["co_pad"], t["tiles_y"] * TILE, t["tiles_x"] * TILE)[:, :Co, :H, :W]
    return dequantize_plain(acc.contiguous(), scale, bias, out_dtype)


def _check_cuda(fn: str, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{fn} needs CUDA tensors; {name} is on {t.device}")
    if len({t.device for t in tensors.values()}) != 1:
        raise ValueError(f"{fn}: operands on different devices: {[str(t.device) for t in tensors.values()]}")


def qconv_int8_cuda(x: torch.Tensor, x_scale: torch.Tensor, wq: torch.Tensor, packed: torch.Tensor,
                    scale: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                    out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Launch the fused kernel: x ``[N, C, H, W]`` float32 or bfloat16 (any
    strides), ``x_scale`` a float32 scalar, ``wq [Co, k, k, Cp]`` int8 with
    Cp = ``padded_channels(C)`` and ``packed`` its :func:`pack_weight` for
    ``n_tile(Co)``, which the kernel reads; ``scale`` and ``bias`` ``[Co]``
    float32 for a float ``out_dtype`` -> ``[N, Co, H, W]``."""
    global qconv_int8_launches
    from . import _kernels

    _check_cuda("qconv_int8_cuda", x=x, x_scale=x_scale, wq=wq)
    if x.ndim != 4 or x.dtype not in _IN_CODE:
        raise ValueError(f"qconv_int8_cuda takes NCHW float32 or bfloat16 x; got {tuple(x.shape)} {x.dtype}")
    if x_scale.numel() != 1 or x_scale.dtype != torch.float32:
        raise ValueError(f"qconv_int8_cuda takes a float32 scalar x_scale; got {tuple(x_scale.shape)} {x_scale.dtype}")
    N, C, H, W = x.shape
    if wq.ndim != 4 or wq.dtype != torch.int8:
        raise ValueError(f"qconv_int8_cuda takes rank-4 int8 weights; got {tuple(wq.shape)} {wq.dtype}")
    Co, k, k2, Cp = wq.shape
    if k != k2 or k not in KERNEL_SIZES or Cp != padded_channels(C):
        raise ValueError(f"qconv_int8_cuda takes square odd k in {KERNEL_SIZES} and weights over "
                         f"{padded_channels(C)} channels; got x {tuple(x.shape)}, wq {tuple(wq.shape)}")
    if out_dtype not in _OUT_CODE:
        raise ValueError(f"qconv_int8_cuda writes int32, float32 or bfloat16; got {out_dtype}")
    ptrs = (0, 0)
    if out_dtype != torch.int32:
        for name, t in (("scale", scale), ("bias", bias)):
            if t is None or t.dtype != torch.float32 or t.shape != (Co,) or not t.is_contiguous():
                raise ValueError(f"qconv_int8_cuda: {name} must be a contiguous float32 [{Co}] tensor")
            _check_cuda("qconv_int8_cuda", x=x, **{name: t})
        ptrs = (scale.data_ptr(), bias.data_ptr())
    bn = n_tile(Co)
    want = (Cp // CHUNK, k * k, -(-Co // bn) * bn // 8, 2, 8, 16)
    if packed is None or packed.shape != want or packed.dtype != torch.int8 or not packed.is_contiguous():
        got = None if packed is None else (tuple(packed.shape), packed.dtype)
        raise ValueError(f"qconv_int8_cuda: packed weights must be contiguous int8 {want}; got {got}")
    _check_cuda("qconv_int8_cuda", x=x, packed=packed)
    out = torch.empty((N, Co, H, W), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        _kernels.qconv_launch(x.data_ptr(), x_scale.data_ptr(), packed.data_ptr(), *ptrs, out.data_ptr(),
                              *x.stride(), N, C, H, W, Co, k, bn, _IN_CODE[x.dtype], _OUT_CODE[out_dtype])
    qconv_int8_launches += 1
    return out


def qconv_int8(x: torch.Tensor, x_scale: torch.Tensor, wq: torch.Tensor, scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.int32,
               packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``qconv_int8_plain(quantize_int8_plain(x, x_scale), ...)`` on CPU
    tensors, the fused kernel on CUDA tensors (which needs ``packed``)."""
    if x.device.type == "cpu":
        return qconv_int8_plain(quantize_int8_plain(x, x_scale), wq, scale, bias, out_dtype)
    return qconv_int8_cuda(x, x_scale, wq, packed, scale, bias, out_dtype)

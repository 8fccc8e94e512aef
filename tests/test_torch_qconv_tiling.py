"""The int8 conv kernel's tiling (``vfi_tpu_torch/ops/csrc/qconv_int8.cu``),
emulated in torch by ``ops.qconv.qconv_int8_tiled``, against the plain
versions on the CPU: ``qconv_int8_plain(quantize_int8_plain(x, s), wq)``.

The emulation stages each m64 tile's halo byte for byte as the kernel does
(the fused quantize included), reads A and B through the no-swizzle wgmma
descriptors' start / LBO / SBO, copies the weights in the producer's stages
and drops what lies past the map and past Co.  Every int8 conv shape of
TAI_gray's forward and SloMo_color's 7x7 and 1x1 convs, at 1 image, with
float32 and with bfloat16 x: the int32 sums exact, and the float32 and
bfloat16 outputs of the plain epilogue on them bit-equal.  The tile choice
fits the card (shared memory, at least two weight stages) at each shape.
The kernel's quantize arithmetic (``x * fl(1/s)`` rounded by adding 1.5 *
2^23, values near a half-integer redone by division) gives
``quantize_int8_plain``'s bytes on values placed next to the half-integers
of ``x / s``, where the fast product alone would not.
Nothing of vfi_tpu is needed: the plain versions are the reference here,
and tests/test_torch_quant.py holds them to vfi_tpu.
"""

import numpy as np
import pytest
import torch

from vfi_tpu_torch.nn import quant
from vfi_tpu_torch.ops import qconv
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

# (C_in, C_out, k, H, W) of every int8 conv call of one TAI_gray forward
# (gray 128x128, K=T=F=5; a forward pre-hook on every QConv), 36 shapes.
TAI_GRAY_SHAPES = [
    (1, 64, 3, 128, 128), (1, 64, 5, 128, 128), (51, 51, 3, 128, 128), (64, 1, 3, 128, 128), (64, 51, 3, 64, 64),
    (64, 64, 3, 32, 32), (64, 64, 3, 64, 64), (64, 64, 3, 128, 128), (64, 128, 3, 64, 64), (64, 128, 5, 64, 64),
    (65, 64, 3, 64, 64), (128, 64, 3, 32, 32), (128, 64, 3, 64, 64), (128, 64, 3, 128, 128), (128, 128, 3, 16, 16),
    (128, 128, 3, 32, 32), (128, 128, 3, 64, 64), (128, 256, 3, 16, 16), (128, 256, 3, 32, 32),
    (128, 256, 7, 32, 32), (256, 64, 3, 64, 64), (256, 128, 3, 16, 16), (256, 128, 3, 32, 32),
    (256, 128, 3, 64, 64), (256, 256, 3, 8, 8), (256, 256, 3, 16, 16), (256, 256, 3, 32, 32), (256, 512, 3, 8, 8),
    (512, 128, 3, 32, 32), (512, 256, 3, 8, 8), (512, 256, 3, 16, 16), (512, 256, 3, 32, 32), (512, 512, 3, 4, 4),
    (512, 512, 3, 8, 8), (512, 1024, 3, 16, 16), (1024, 256, 3, 16, 16),
]
# SloMo_color's 7x7 first convs and 1x1 out convs at 256x320 (chip_smoke.SLOMO_QCONV_SHAPES).
SLOMO_SHAPES = [(6, 32, 7, 256, 320), (16, 32, 7, 256, 320), (32, 32, 7, 256, 320), (32, 4, 1, 256, 320),
                (32, 5, 1, 256, 320)]
SHAPES = TAI_GRAY_SHAPES + SLOMO_SHAPES


def test_shape_lists():
    assert len(set(TAI_GRAY_SHAPES)) == 36 and len(set(SLOMO_SHAPES)) == 5


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_tiled_emulation_equals_plain(shape):
    cin, cout, k, h, w = shape
    cp = qconv.padded_channels(cin)
    tiles = qconv.qconv_tiles(h, w, cp, cout, k)
    assert tiles["depth"] >= 2 and tiles["smem"] <= qconv.SMEM_MAX, tiles
    assert tiles["bn"] >= min(cout, 256) and tiles["co_pad"] % tiles["bn"] == 0

    rng = np.random.RandomState(cin * 7 + cout * 3 + k + h)
    x = rng.standard_normal((1, cin, h, w)).astype(np.float32) * 2
    wq = rng.randint(-127, 128, (cout, k, k, cp)).astype(np.int8)
    wq[..., cin:] = 0  # as QConv.quantized_weight pads
    wq = torch.from_numpy(wq)
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-3, cout).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(cout) * 0.1).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dtype)
        s = torch.clamp_min(xt.float().abs().amax() * quant.INV_127, quant.EPS)
        acc_plain = qconv.qconv_int8_plain(qconv.quantize_int8_plain(xt, s), wq)
        acc = qconv.qconv_int8_tiled(xt, s, wq)
        assert acc.dtype == torch.int32 and acc.shape == (1, cout, h, w)
        assert torch.equal(acc, acc_plain), f"{dtype}: int32 sums off by {(acc - acc_plain).abs().max()}"
        for out in (torch.float32, torch.bfloat16):
            got = qconv.dequantize_plain(acc, scale, bias, out)
            want = qconv.dequantize_plain(acc_plain, scale, bias, out)
            assert got.dtype == out and torch.equal(got, want), f"{dtype} x, {out} out"


# x_scale values: dynamic scales of typical activations, at 1 and above, and
# tiny; then two whose reciprocal is not a normal float32 (subnormal, and
# past the largest float), where the kernel quantizes by division throughout.
SCALES = (1.0, 2 / 127, 3e-3, 1 / 127, 7.3e-5, 2.5, 0.0123456, 1e-30)
ODD_SCALES = (1e38, 1e-39)


def values_near_halves(s: float) -> torch.Tensor:
    """float32 values within 8 ulps of (n + 1/2) * s, n in [-129, 128]
    (the clamp at +-127.5 included), where finite."""
    n = np.arange(-129, 129, dtype=np.float64) + 0.5
    base = (n * np.float64(np.float32(s)))
    base = base[np.abs(base) < 3e38].astype(np.float32)
    vals, up, down = [base], base, base
    for _ in range(8):
        up, down = np.nextafter(up, np.float32(np.inf)), np.nextafter(down, np.float32(-np.inf))
        vals += [up, down]
    return torch.from_numpy(np.concatenate(vals))


@pytest.mark.parametrize("s", SCALES + ODD_SCALES)
def test_quantize_staged_equals_plain(s):
    v, st = values_near_halves(s), torch.tensor(s, dtype=torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        x = v.to(dtype)
        want = qconv.quantize_int8_plain(x.reshape(1, -1, 1, 1), st).reshape(-1)[:v.numel()]
        got = qconv.quantize_staged(x, st)
        assert torch.equal(got, want), f"{dtype}: {int((got != want).sum())} bytes differ"


def test_quantize_fast_needs_its_redo():
    """The product x * fl(1/s) rounds otherwise than fl(x / s) next to some
    half-integers, and only where quantize_fast flags the value."""
    missed = 0
    for s in SCALES:
        v, st = values_near_halves(s), torch.tensor(s, dtype=torch.float32)
        want = qconv.quantize_int8_plain(v.reshape(1, -1, 1, 1), st).reshape(-1)[:v.numel()]
        fast, near = qconv.quantize_fast(v, torch.reciprocal(st))
        assert torch.equal(fast[~near], want[~near]), s
        missed += int((fast != want).sum())
    assert missed > 0

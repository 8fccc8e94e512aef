"""The frozen bounds equal the port's bring-up bounds (chip_smoke.py) at its shapes."""

import pytest
import torch

from portbench.counts import bounds
from portbench.counts.peaks import PEAKS, peak

chip_smoke = pytest.importorskip("chip_smoke")
SHAPES = [(320, 128, 128, 1), (80, 240, 320, 3), (40, 128, 128, 1), (20, 256, 320, 3)]


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_sepconv_bounds(shape, dtype):
    B, H, W, C = shape
    ks = chip_smoke.KS
    elem = torch.tensor([], dtype=dtype).element_size()
    _, smoke_peak = chip_smoke.peaks("NVIDIA H100 80GB HBM3")
    pk = peak("NVIDIA H100 80GB HBM3")
    x = _meta((B, H + ks - 1, W + ks - 1, C), dtype)
    v, g = _meta((B, H, W, ks), dtype), _meta((B, H, W, C), dtype)
    want = {"fwd": chip_smoke.sepconv_bound_ms(x, v, v, smoke_peak)[0],
            "vh": chip_smoke.sepconv_bwd_vh_bound_ms(x, v, v, g, smoke_peak)[0],
            "x": chip_smoke.sepconv_bwd_x_bound_ms(v, v, g, smoke_peak)[0]}
    got = {"fwd": bounds.sepconv_fwd_s(B, H, W, C, ks, elem, pk), "vh": bounds.sepconv_bwd_vh_s(B, H, W, C, ks, elem, pk),
           "x": bounds.sepconv_bwd_x_s(B, H, W, C, ks, elem, pk)}
    for k in want:
        assert got[k] * 1e3 == pytest.approx(want[k], rel=1e-12), k


@pytest.mark.parametrize("call", [(64, 1, 64, 5, 128, 128), (640, 256, 256, 3, 16, 16), (640, 512, 256, 3, 16, 16),
                                  (128, 256, 256, 3, 32, 32)])
def test_qconv_bound(call):
    for name in PEAKS:
        _, smoke_peak = chip_smoke.peaks(name)
        want = chip_smoke.qconv_bound_ms(*call, 2, 2, smoke_peak)[0]
        assert bounds.qconv_s(*call, 2, 2, peak(name)) * 1e3 == pytest.approx(want, rel=1e-12)


def test_peaks_are_the_data_sheets():
    for name in PEAKS:
        _, (bw, bf16, f32) = chip_smoke.peaks(name)
        p = peak(name)
        assert (p.bytes_s, p.bf16, p.f32, p.int8) == (bw, bf16, f32, chip_smoke.int8_peak((bw, bf16, f32)))

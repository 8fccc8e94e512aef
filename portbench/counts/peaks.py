"""Data-sheet peaks (dense, no sparsity) of the cards the benchmark knows,
matched on the name ``torch.cuda.get_device_name`` reports; the first match
wins.  Each: bytes/s of device memory, bf16 tensor-core FLOP/s, float32
FLOP/s outside the tensor cores, int8 tensor-core OP/s (twice the bf16
rate on these cards, as the bring-up bounds take it)."""

from __future__ import annotations

from typing import NamedTuple, Optional


class Peak(NamedTuple):
    bytes_s: float
    bf16: float
    f32: float
    int8: float


PEAKS = {
    "H100 PCIe": Peak(2.0e12, 756e12, 51e12, 2 * 756e12),
    "H100 NVL": Peak(3.9e12, 835e12, 60e12, 2 * 835e12),
    "H200": Peak(4.8e12, 989e12, 67e12, 2 * 989e12),
    "H100": Peak(3.35e12, 989e12, 67e12, 2 * 989e12),  # SXM
}


def peak(device_name: str) -> Optional[Peak]:
    for key, val in PEAKS.items():
        if key in device_name:
            return val
    return None

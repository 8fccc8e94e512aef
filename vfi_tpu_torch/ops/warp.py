"""Backward warping by optical flow (counterpart of ``vfi_tpu/ops/warp.py``), NCHW.

``out[y, x] = img[y + v, x + u]``, bilinear, zero outside the frame; the
flow ``[B, 2, H, W]`` holds (u, v) in pixels.  Two modes, as in vfi_tpu:

  * ``"pixel"``: sample at ``(x + u, y + v)``;
  * ``"torch03"``: the reference FlowWarper's normalise/denormalise round
    trip, which lands at ``(x + u) * (W-1)/W`` (and likewise for y), for
    imported reference SloMo checkpoints.

Two routes compute the same function:

  * :func:`flow_warp` (the models' route): ``F.grid_sample`` with
    ``align_corners=True`` and zero padding, which zeroes each corner that
    falls outside the frame, as vfi_tpu's ``valid`` mask does;
  * :func:`flow_warp_gather`: vfi_tpu's four masked gathers written out,
    the plain version the tests hold the first against.

The sampling coordinates are float32 whatever the image's dtype: in vfi_tpu
``x + u`` promotes to float32 against its float32 iota, and a bf16
coordinate would resolve only about 2 pixels at x ~ 300.  ``grid_sample``
takes its grid in the image's dtype, so :func:`flow_warp` samples a float32
copy of the image and returns the result in the image's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MODES = ("pixel", "torch03")


def _sample_coords(flow: torch.Tensor, mode: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Float32 pixel coordinates (px, py), each ``[B, H, W]``, of a flow ``[B, 2, H, W]``."""
    if mode not in MODES:
        raise ValueError(f"unknown flow_warp mode {mode!r}")
    _, _, H, W = flow.shape
    flow = flow.float()
    gy = torch.arange(H, dtype=torch.float32, device=flow.device)[:, None]
    gx = torch.arange(W, dtype=torch.float32, device=flow.device)[None, :]
    px = gx + flow[:, 0]
    py = gy + flow[:, 1]
    if mode == "torch03":
        px = px * ((W - 1) / W)
        py = py * ((H - 1) / H)
    return px, py


def flow_warp(img: torch.Tensor, flow: torch.Tensor, mode: str = "pixel") -> torch.Tensor:
    """Bilinear backward warp of ``img`` ``[B, C, H, W]`` by ``flow`` ``[B, 2, H, W]``."""
    px, py = _sample_coords(flow, mode)
    _, _, H, W = img.shape
    # align_corners=True maps -1 to pixel 0 and +1 to pixel W-1.
    grid = torch.stack([px * (2.0 / max(W - 1, 1)) - 1.0, py * (2.0 / max(H - 1, 1)) - 1.0], dim=-1)
    out = F.grid_sample(img.float(), grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    return out.to(img.dtype)


def flow_warp_gather(img: torch.Tensor, flow: torch.Tensor, mode: str = "pixel") -> torch.Tensor:
    """:func:`flow_warp` as vfi_tpu computes it: four gathers, each masked to
    the frame, blended with float32 weights; the result in the image's dtype."""
    px, py = _sample_coords(flow, mode)
    B, C, H, W = img.shape
    x0, y0 = torch.floor(px), torch.floor(py)
    wx, wy = (px - x0)[:, None], (py - y0)[:, None]
    flat = img.reshape(B, C, H * W)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long().reshape(B, 1, H * W)
        vals = torch.gather(flat, 2, idx.expand(B, C, H * W)).reshape(B, C, H, W)
        return vals.float() * valid[:, None]

    out = (gather(y0, x0) * (1 - wx) * (1 - wy) + gather(y0, x0 + 1) * wx * (1 - wy)
           + gather(y0 + 1, x0) * (1 - wx) * wy + gather(y0 + 1, x0 + 1) * wx * wy)
    return out.to(img.dtype)

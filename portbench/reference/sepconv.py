"""Adaptive separable convolution, plain PyTorch: the benchmark's reference.

    out[b, y, x, c] = sum_{fy, fx} x[b, y+fy, x+fx, c] * v[b, y, x, fy] * h[b, y, x, fx]

``x`` is the replication-padded input ``[B, H+ks-1, W+ks-1, C]``, ``v`` and
``h`` are ``[B, H, W, ks]``.  The forward is the banded formulation (the
horizontal pass as a product with ``S[b, y, x, u] = h[b, y, x, u-x]``), the
adjoints its plain transposes; all compute in float32 (float64 stays
float64) in blocks of images, so that a serving batch fits beside the model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Bytes of float32 temporaries one block of images may take.
BLOCK_BYTES = 2 << 30


def _wide(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.promote_types(t.dtype, torch.float32))


def pad_for_sepconv(x: torch.Tensor, ks: int) -> torch.Tensor:
    """Replication-pad NHWC ``x`` by ks//2 per side (one more bottom and right for even ks)."""
    p = ks // 2
    q = p + (ks - 1 - 2 * p)
    return F.pad(x.permute(0, 3, 1, 2), (p, q, p, q), mode="replicate").permute(0, 2, 3, 1)


def _skew_rows(m: torch.Tensor) -> torch.Tensor:
    """``[..., W, ks] -> [..., W, W+ks-1]``, ``out[..., x, u] = m[..., x, u-x]`` on the band, else 0."""
    *lead, W, ks = m.shape
    flat = F.pad(m, (0, W)).reshape(*lead, W * (ks + W))[..., : W * (ks + W - 1)]
    return flat.reshape(*lead, W, ks + W - 1)


def _unskew_rows(m: torch.Tensor, ks: int) -> torch.Tensor:
    W = m.shape[-2]
    idx = torch.arange(W, device=m.device)[:, None] + torch.arange(ks, device=m.device)
    return m.gather(-1, idx.expand(*m.shape[:-1], ks))


def _row_slabs(x: torch.Tensor, H: int, ks: int) -> torch.Tensor:
    """``[B, H, ks, W+ks-1, C]``: ``slabs[b, y, f] = x[b, y+f]``."""
    return torch.stack([x[:, f : f + H] for f in range(ks)], dim=2)


def _blocks(B: int, H: int, W: int, C: int, ks: int):
    """Image ranges whose float32 temporaries stay under BLOCK_BYTES."""
    per_image = 4 * H * (ks * (W + ks - 1) * C + W * (W + ks - 1) + 2 * ks * W * C)
    n = max(1, BLOCK_BYTES // per_image)
    return [(i, min(B, i + n)) for i in range(0, B, n)]


def forward(x: torch.Tensor, v: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    B, H, W, ks = v.shape
    C = x.shape[-1]
    out = []
    for a, b in _blocks(B, H, W, C, ks):
        inner = torch.einsum("byfuc,byxu->byfxc", _row_slabs(_wide(x[a:b]), H, ks), _skew_rows(_wide(h[a:b])))
        out.append(torch.einsum("byfxc,byxf->byxc", inner, _wide(v[a:b])))
    return torch.cat(out).to(x.dtype)


def adjoint_vh(x, v, h, g):
    """(grad_v, grad_h), summed over channels."""
    B, H, W, ks = v.shape
    C = x.shape[-1]
    gv_out, gh_out = [], []
    for a, b in _blocks(B, H, W, C, ks):
        slabs = _row_slabs(_wide(x[a:b]), H, ks)
        gw = _wide(g[a:b])
        inner = torch.einsum("byfuc,byxu->byfxc", slabs, _skew_rows(_wide(h[a:b])))
        gv_out.append(torch.einsum("byfxc,byxc->byxf", inner, gw))
        gvc = _wide(v[a:b])[..., :, None] * gw[..., None, :]
        gh_out.append(_unskew_rows(torch.einsum("byfuc,byxfc->byxu", slabs, gvc), ks))
    return torch.cat(gv_out).to(v.dtype), torch.cat(gh_out).to(h.dtype)


def adjoint_x(v, h, g):
    """grad of the padded input ``[B, H+ks-1, W+ks-1, C]``."""
    B, H, W, ks = v.shape
    C = g.shape[-1]
    out = []
    for a, b in _blocks(B, H, W, C, ks):
        gvc = _wide(v[a:b])[..., :, None] * _wide(g[a:b])[..., None, :]
        G = torch.einsum("byxfc,byxu->byfuc", gvc, _skew_rows(_wide(h[a:b])))
        gx = torch.zeros((b - a, H + ks - 1, W + ks - 1, C), dtype=G.dtype, device=G.device)
        for f in range(ks):
            gx[:, f : f + H] += G[:, :, f]
        out.append(gx)
    return torch.cat(out).to(g.dtype)


class _SepConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, v, h):
        ctx.save_for_backward(x, v, h)
        return forward(x, v, h)

    @staticmethod
    def backward(ctx, g):
        x, v, h = ctx.saved_tensors
        gv, gh = adjoint_vh(x, v, h, g)
        return adjoint_x(v, h, g), gv, gh


def sepconv(x: torch.Tensor, v: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Differentiable in all three operands; returns ``[B, H, W, C]``."""
    return _SepConv.apply(x, v, h)

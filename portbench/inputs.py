"""Inputs made from ``--seed`` on the device: the weights of both networks and
synthetic videos.

Weights come from one draw of normal numbers for all leaves, each leaf then
scaled: convs and linears by sqrt(2 / fan_in), so that activations keep
their size through the ReLU stacks and the served frames are not flat;
biases by 0.01; the kernel heads' last conv (``post_up``) by 1 / ks with
the bias 1 / ks, so that the predicted separable kernels sum to about one
and sepconv blends rather than saturates; power-iteration vectors ``u`` as
drawn.  The same tensors go to the port and to the reference.

A video is a smooth random field (two octaves of bicubically upsampled
noise) translated by a whole number of pixels per frame, each clip with its
own velocity in [-3, 3]^2: content that MC-Net's motion encoder sees move.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MAX_SPEED = 3


def weights(module: torch.nn.Module, gen: torch.Generator, device, ks: int = 0) -> dict:
    """float32 tensors on ``device`` for every entry of ``module.state_dict()``
    (the module may live on the meta device: only names and shapes are read)."""
    shapes = [(k, tuple(t.shape)) for k, t in module.state_dict().items()]
    total = sum(math.prod(s) for _, s in shapes)
    noise = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        a = noise[off : off + n].view(shape)
        off += n
        head = ".post_up." in f".{name}" and ks
        if name.endswith(".u"):
            out[name] = a.clone()
        elif name.endswith("weight"):
            out[name] = a * (math.sqrt(2.0 / math.prod(shape[1:])) / (ks if head else 1))
        else:
            out[name] = (a * 0.01 + 1.0) / ks if head else a * 0.01
    return out


def videos(n: int, frames: int, H: int, W: int, C: int, gen: torch.Generator, device, contrast=None) -> torch.Tensor:
    """uint8 ``[n, frames, H, W, C]`` on ``device``; with ``contrast = (lo, hi)``
    clip i's contrast about mid-gray is lo + (hi - lo) * i / (n - 1), so the
    clips weigh unequally in a batch's mean loss."""
    m = MAX_SPEED * (frames - 1)
    Hf, Wf = H + 2 * m, W + 2 * m
    coarse = torch.rand(n, C, Hf // 24 + 2, Wf // 24 + 2, generator=gen, device=device)
    fine = torch.rand(n, C, Hf // 6 + 2, Wf // 6 + 2, generator=gen, device=device)
    field = (F.interpolate(coarse, size=(Hf, Wf), mode="bicubic", align_corners=False) * 0.8
             + F.interpolate(fine, size=(Hf, Wf), mode="bicubic", align_corners=False) * 0.3 - 0.05)
    if contrast is not None:
        lo, hi = contrast
        c = lo + (hi - lo) * torch.arange(n, device=device) / max(n - 1, 1)
        field = 0.5 + (field - 0.5) * c[:, None, None, None]
    field = field.clamp(0.0, 1.0).permute(0, 2, 3, 1)  # [n, Hf, Wf, C]
    vel = torch.randint(-MAX_SPEED, MAX_SPEED + 1, (n, 2), generator=gen, device=device)
    t = torch.arange(frames, device=device)
    oy = m + vel[:, :1] * t  # [n, frames]
    ox = m + vel[:, 1:] * t
    rows = oy[:, :, None, None] + torch.arange(H, device=device)[:, None]  # [n, frames, H, 1]
    cols = ox[:, :, None, None] + torch.arange(W, device=device)  # [n, frames, 1, W]
    b = torch.arange(n, device=device)[:, None, None, None]
    return torch.round(field[b, rows, cols] * 255.0).to(torch.uint8)


def to_model(u8: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> float32 in [-1, 1]."""
    return u8.float() / 255.0 * 2.0 - 1.0

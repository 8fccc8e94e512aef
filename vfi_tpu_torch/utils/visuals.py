"""TensorBoard visualisation helpers (a copy of ``vfi_tpu/utils/visuals.py``).

Channels-last numpy throughout.  ``draw_err_plot`` decodes matplotlib's PNG
with the port's own reader (``utils/png.py``), since the card's machine has
no PIL, and keeps RGB as PIL's ``convert("RGB")`` does; matplotlib is
imported only when a plot is drawn.
"""

from __future__ import annotations

import io
from typing import Dict

import numpy as np

from ..ops.image import inverse_transform
from .png import decode_png


def draw_frame_borders(video: np.ndarray, K: int, T: int) -> np.ndarray:
    """Green borders on the context frames, red on the generated ones.

    :param video: [B, Ttot, H, W, 3] floats in [0, 1] (RGB)
    """
    v = video.copy()
    v[:, :, :2, :, :] = 0
    v[:, :, -2:, :, :] = 0
    v[:, :, :, :2, :] = 0
    v[:, :, :, -2:, :] = 0

    def _edges(sel, channel):
        v[:, sel, :2, :, channel] = 1
        v[:, sel, -2:, :, channel] = 1
        v[:, sel, :, :2, channel] = 1
        v[:, sel, :, -2:, channel] = 1

    ctx = list(range(K)) + list(range(K + T, v.shape[1]))
    _edges(ctx, 1)  # green
    _edges(list(range(K, K + T)), 0)  # red
    return v


def make_grid(images: np.ndarray, nrow: int, pad: int = 2) -> np.ndarray:
    """[N, H, W, 3] -> one [GH, GW, 3] grid image (values clipped to [0, 1])."""
    N, H, W, C = images.shape
    ncol = nrow
    nr = (N + ncol - 1) // ncol
    grid = np.zeros((nr * (H + pad) + pad, ncol * (W + pad) + pad, C), images.dtype)
    for i in range(N):
        r, c = divmod(i, ncol)
        y, x = pad + r * (H + pad), pad + c * (W + pad)
        grid[y : y + H, x : x + W] = images[i]
    return np.clip(grid, 0.0, 1.0)


def visual_grid(visuals: Dict[str, np.ndarray], K: int, T: int) -> np.ndarray:
    """One grid image of annotated sequences from a dict of [B, Ttot, H, W, C]
    videos in [-1, 1] (BGR), one sequence of seq_len frames per row."""
    seqs = []
    seq_len = None
    for _, vis in visuals.items():
        vis = np.asarray(inverse_transform(vis))
        if vis.shape[-1] == 1:
            vis = np.repeat(vis, 3, axis=-1)
        else:
            vis = vis[..., ::-1]  # BGR -> RGB
        seqs.append(draw_frame_borders(vis, K, T))
        seq_len = vis.shape[1]
    grouped = np.stack(seqs, axis=1)  # [B, nvis, Ttot, H, W, 3]
    flat = grouped.reshape(-1, *grouped.shape[3:])
    return make_grid(flat, nrow=seq_len)


def draw_err_plot(err: np.ndarray, err_name: str, lims=None, path: str | None = None):
    """The average PSNR/SSIM-per-timestep plot.

    :param err: [N, T] per-video, per-timestep metric values
    :return: an RGB uint8 image if ``path`` is None, else None (the plot is
        written to ``path``)
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    avg = err.mean(axis=0)
    Tn = err.shape[1]
    fig, ax = plt.subplots()
    x = np.arange(1, Tn + 1)
    ax.plot(x, avg, marker="d")
    ax.set_xlabel("time steps")
    ax.set_ylabel(err_name)
    ax.grid(True)
    ax.set_xticks(x)
    if lims is not None:
        ax.axis(lims)
    if path is not None:
        fig.savefig(path)
        plt.close(fig)
        return None
    buf = io.BytesIO()
    fig.savefig(buf, format="png")
    plt.close(fig)
    return np.ascontiguousarray(decode_png(buf.getvalue())[..., :3])  # Agg writes RGBA

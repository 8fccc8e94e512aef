"""Dynamic (K, T, F): pad-to-max layouts and masks (counterpart of
``vfi_tpu/ops/dynamic.py``).

A clip is laid out once at the largest lengths (max_K, max_T, max_F) and the
sampled lengths enter as 0-d int64 tensors on the clip's device:

  * preceding frames are RIGHT-aligned in a max_K buffer (the content frame
    is always at index -1),
  * middle and following frames are LEFT-aligned in max_T / max_F buffers
    (the first following frame is always at index 0),
  * every consumer (the warm-up, the blend weights, the losses, the
    discriminator's windows) reads masks and index vectors built on the
    device from those tensors.

No helper reads a length on the host (no ``.item()``, ``int()`` or Python
``if`` on one), so one step launches the same kernels at every (K, T, F):
the form of a step that a CUDA graph could capture once for all lengths.
Gathers clamp their indices, as vfi_tpu's ``jnp.take`` does, so the padding
holds the same finite frames in both packages.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

Lengths = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def as_lengths(lengths, device, maxima: Sequence[int], minima: Sequence[int] = (1, 1, 1)) -> Lengths:
    """``(K, T, F)`` as 0-d int64 tensors on ``device``.

    ``lengths`` is one ``[3]`` tensor ``ktf`` or three values.  Python or
    numpy integers are checked on the host against ``minima <= (K, T, F) <=
    maxima`` before the upload and raise ``ValueError`` outside it; tensors
    are taken as they are, since reading one on a card would wait for it.
    """
    if torch.is_tensor(lengths) and lengths.dim() == 1:
        lengths = lengths.unbind(0)
    if len(lengths) != 3:
        raise ValueError(f"lengths must be (K, T, F); got {len(lengths)} values")
    out = []
    for name, x, lo, hi in zip("KTF", lengths, minima, maxima):
        if not torch.is_tensor(x):
            if not isinstance(x, (int, np.integer)):
                raise ValueError(f"{name} must be an integer; got {x!r}")
            if not lo <= x <= hi:
                raise ValueError(f"{name}={x} is outside [{lo}, {hi}]")
        out.append(torch.as_tensor(x, dtype=torch.int64).to(device, non_blocking=True))
    return tuple(out)


def _gather_time(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Frames of ``x`` along dim 1 at a clamped ``[L_out]`` index vector."""
    return x.index_select(1, idx.clamp(0, x.shape[1] - 1))


def pack_context(targets: torch.Tensor, K, T, F, max_K: int, max_T: int, max_F: int):
    """A max-length clip ``[B, >= max_K+max_T+max_F, ...]`` as padded
    (preceding, middle, following), the buffers of the static path's
    ``targets[:, :K]``, ``targets[:, K:K+T]`` and ``targets[:, K+T:K+T+F]``:

      preceding ``[B, max_K]``, right-aligned (valid j >= max_K - K);
      middle ``[B, max_T]``, left-aligned (valid t < T);
      following ``[B, max_F]``, left-aligned (valid j < F).
    """
    dev = targets.device
    preceding = _gather_time(targets, torch.arange(max_K, device=dev) - (max_K - K))
    middle = _gather_time(targets, K + torch.arange(max_T, device=dev))
    following = _gather_time(targets, K + T + torch.arange(max_F, device=dev))
    return preceding, middle, following


def middle_mask(T: torch.Tensor, max_T: int, dtype=torch.float32) -> torch.Tensor:
    """``[max_T]`` validity of the left-aligned middle frames."""
    return (torch.arange(max_T, device=T.device) < T).to(dtype)


def dynamic_time_weights(T: torch.Tensor, max_T: int, dtype=torch.float32) -> torch.Tensor:
    """``w[t] = (t+1)/(T+1)`` for t < T, else 0: ``linspace(0, 1, T+2)[1:-1]``
    at a length held on the device."""
    t = torch.arange(max_T, dtype=dtype, device=T.device)
    return (t + 1.0) / (T.to(dtype) + 1.0) * middle_mask(T, max_T, dtype)


def reverse_middle(x_tmajor: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """A time-major ``[max_T, ...]`` backward rollout in natural middle order:
    position t takes rollout step T-1-t (clamped)."""
    max_T = x_tmajor.shape[0]
    idx = (T - 1 - torch.arange(max_T, device=x_tmajor.device)).clamp(0, max_T - 1)
    return x_tmajor.index_select(0, idx)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    """Mean of ``x`` where ``mask`` is 1 (the mask broadcasts against x); a
    count of 0 divides by 1."""
    mask = mask.to(x.dtype).expand_as(x)
    if dim is None:
        return (x * mask).sum() / mask.sum().clamp_min(1.0)
    return (x * mask).sum(dim) / mask.sum(dim).clamp_min(1.0)


def compact_video(preceding, pred, following, K, T, F) -> torch.Tensor:
    """The real K+T+F frames of the padded segments as one left-aligned video
    ``[B, max_K+max_T+max_F, ...]`` (clamped padding at the end): the
    sliding-window discriminator's input at any sampled lengths."""
    max_K, max_T = preceding.shape[1], pred.shape[1]
    video = torch.cat([preceding, pred, following], dim=1)
    i = torch.arange(video.shape[1], device=video.device)
    idx = torch.where(i < K, max_K - K + i,
                      torch.where(i < K + T, max_K + i - K, max_K + max_T + i - K - T))
    return _gather_time(video, idx)


def dynamic_window_labels(K, T, F, max_L: int, window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(labels, valid) of the discriminator's windows over a compact video,
    each ``[max_L - window + 1]`` float32: labels 1 for windows wholly inside
    the preceding or following frames, valid 0 for windows touching the
    padding."""
    s = torch.arange(max_L - window + 1, device=K.device)
    real_len = K + T + F
    inside = s + window <= real_len
    labels = (s + window <= K) | ((s >= K + T) & inside)
    return labels.float(), inside.float()

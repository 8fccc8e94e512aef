"""VGG16 features for the SloMo perceptual loss (counterpart of ``vfi_tpu/nn/vgg.py``).

conv1_1 .. conv4_3, a ReLU after each conv, a 2x2 max pool between stages,
on images normalised with torchvision's mean and std: the reference's
``vgg16(pretrained=True).features[:22]`` (relu4_3).  Pretrained weights are
not downloaded: they come from an ``.npz`` with vfi_tpu's keys,
``convN_M/kernel`` (HWIO) and ``convN_M/bias``.  Without a path the network
is unavailable, and ``SloMoEnvironment`` refuses ``lambda_p > 0``.
:func:`random_vgg16_npz` writes such a file from a numpy seed, for tests and
smoke runs.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv

# (width, layers) of the stages of conv1_1 .. conv4_3
_CFG = [(64, 2), (128, 2), (256, 3), (512, 3)]
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def _layers():
    """(name, in_features, width) of every conv, in order."""
    cin = 3
    for si, (width, layers) in enumerate(_CFG):
        for li in range(layers):
            yield f"conv{si + 1}_{li + 1}", cin, width
            cin = width


class VGG16Features(nn.Module):
    """relu4_3 features ``[N, 512, H/8, W/8]`` of images ``[N, 3, H, W]`` in [0, 1]."""

    def __init__(self):
        super().__init__()
        for name, cin, width in _layers():
            self.add_module(name, Conv(cin, width, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = torch.tensor(_MEAN, dtype=x.dtype, device=x.device)[:, None, None]
        std = torch.tensor(_STD, dtype=x.dtype, device=x.device)[:, None, None]
        x = (x - mean) / std
        for si, (_, layers) in enumerate(_CFG):
            for li in range(layers):
                x = F.relu(getattr(self, f"conv{si + 1}_{li + 1}")(x))
            if si < len(_CFG) - 1:
                x = F.max_pool2d(x, 2)
        return x


def load_vgg16_params(npz_path: str) -> Dict[str, torch.Tensor]:
    """The ``.npz`` at ``npz_path`` as a :class:`VGG16Features` state_dict."""
    data = np.load(npz_path)
    state = {}
    for name, _, _ in _layers():
        state[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(data[f"{name}/kernel"], np.float32).transpose(3, 2, 0, 1)))
        state[f"{name}.bias"] = torch.from_numpy(np.asarray(data[f"{name}/bias"], np.float32).copy())
    return state


def try_load_vgg16(npz_path: Optional[str]) -> Optional[VGG16Features]:
    """A frozen :class:`VGG16Features` (on the CPU, in eval mode) with the
    weights of ``npz_path``, or None when no path was given.  A path that is
    given but cannot be loaded raises ``RuntimeError``: dropping the
    perceptual term silently would train another loss than the reference's."""
    if not npz_path:
        return None
    try:
        state = load_vgg16_params(npz_path)
        model = VGG16Features()
        model.load_state_dict(state)
    except (OSError, KeyError, ValueError, RuntimeError) as e:
        raise RuntimeError(
            f"could not load VGG16 weights from {npz_path}: {e}. "
            "Convert a torchvision vgg16 state_dict with cli/convert_vgg16.py."
        ) from e
    return model.eval().requires_grad_(False)


def random_vgg16_npz(path: str, seed: int) -> str:
    """Write VGG16 weights drawn from ``np.random.RandomState(seed)`` to
    ``path`` with vfi_tpu's keys: per conv in order, the kernel He-normal
    (std sqrt(2/fan_in), so activations keep their scale through the ReLU
    stack), then the bias as small normals.  Returns ``path``."""
    rng = np.random.RandomState(seed)
    arrays = {}
    for name, cin, width in _layers():
        arrays[f"{name}/kernel"] = (rng.standard_normal((3, 3, cin, width)) * np.sqrt(2.0 / (9 * cin))).astype(
            np.float32)
        arrays[f"{name}/bias"] = (rng.standard_normal(width) * 0.01).astype(np.float32)
    with open(path, "wb") as f:  # the name as given (np.savez would append .npz)
        np.savez(f, **arrays)
    return path

"""Serving API (counterpart of ``vfi_tpu/api.py``).

    from vfi_tpu_torch.api import VideoInpainter
    ip = VideoInpainter("TAI_gray", state_dict, dtype=torch.bfloat16)   # on cuda
    middles = ip.inpaint(preceding_u8, following_u8, T=5)               # uint8 in/out

    ip = VideoInpainter.from_checkpoint("TAI_gray", "checkpoints/kth_bi-TAI")   # model_best.ckpt

``state_dict`` is a port state_dict, e.g. ``params_from_jax(flax_params)``;
``from_checkpoint`` reads the generator of a port snapshot
(``utils/checkpoint.py``; ``cli.import_torch_checkpoint`` writes one from a
reference checkpoint).  The model runs on ``cuda`` unless the caller
passes ``device="cpu"``.  A host model (``OFFillInModel``, which has
``host_forward``) needs no state_dict, snapshot, device or dtype: it runs on
the host in float32, as in vfi_tpu::

    ip = VideoInpainter("OFFillInModel")
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np
import torch

from .models.registry import ModelSpec, create_model, is_host_model, model_config
from .ops.image import BGR_LUMA
from .utils import checkpoint as ckpt


def resolve_device(device=None) -> torch.device:
    """``cuda`` by default; raise when a GPU is wanted and none is present
    (the CPU must be asked for).  Under a torchrun launch (``LOCAL_RANK``
    set), ``cuda`` is the rank's own card, ``cuda:LOCAL_RANK``, and a rank
    without one raises; an explicit ``cuda:N`` is kept as given."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
    local_rank = os.environ.get("LOCAL_RANK")
    if device.type == "cuda" and device.index is None and local_rank is not None:
        if int(local_rank) >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK={local_rank} but {torch.cuda.device_count()} CUDA device(s) are visible: "
                               "launch at most one rank per card, or name each rank's card with --device cuda:N")
        device = torch.device("cuda", int(local_rank))
    return device


class VideoInpainter:
    def __init__(self, model: ModelSpec, state_dict: Optional[Mapping[str, torch.Tensor]] = None, device=None,
                 dtype: torch.dtype = torch.float32):
        if is_host_model(model):
            self.model, self.device, self.dtype = create_model(model), None, torch.float32
            self._host = self.model.host_forward
            return
        if state_dict is None:
            raise ValueError(f"{model_config(model)['class']} has weights: pass a state_dict, or use from_checkpoint")
        self.device = resolve_device(device)
        self.dtype = dtype
        self._host = None
        self.model = create_model(model)
        self.model.load_state_dict(state_dict)
        self.model.to(device=self.device, dtype=dtype).eval()

    @classmethod
    def from_checkpoint(cls, model_key: ModelSpec, checkpoint_dir: Optional[str] = None,
                        snapshot: str = "model_best.ckpt", dtype: torch.dtype = torch.float32,
                        device=None) -> "VideoInpainter":
        """Serve the generator of the snapshot ``checkpoint_dir/snapshot``
        (a host model reads none)."""
        if is_host_model(model_key):
            return cls(model_key)
        payload, _ = ckpt.load_snapshot(checkpoint_dir, snapshot)
        return cls(model_key, payload["generator"], device=device, dtype=dtype)

    @staticmethod
    def _frames(frames_u8: np.ndarray, gray: bool) -> np.ndarray:
        """uint8 RGB or single-channel frames -> the model's float32 BGR [-1, 1] video."""
        x = frames_u8.astype(np.float32) / 255.0
        if x.ndim == 4:  # [T, H, W, C] -> add batch
            x = x[None]
        if x.shape[-1] == 3:
            x = x[..., ::-1]  # RGB -> BGR (the model's channel order)
            if gray:
                x = (x @ np.asarray(BGR_LUMA, np.float32))[..., None]
        return np.ascontiguousarray(x * 2.0 - 1.0)

    def _to_model(self, frames_u8: np.ndarray, gray: bool) -> torch.Tensor:
        return torch.from_numpy(self._frames(frames_u8, gray)).to(device=self.device, dtype=self.dtype)

    @torch.inference_mode()
    def forward(self, T: int, preceding: torch.Tensor, following: torch.Tensor) -> torch.Tensor:
        """Model-space forward: [-1, 1] videos ``[B, K|F, H, W, C]`` -> ``pred``."""
        return self.model(T, preceding, following)["pred"]

    def inpaint(self, preceding_u8: np.ndarray, following_u8: np.ndarray, T: int) -> np.ndarray:
        """uint8 frames ``[B?, K, H, W, C]`` + ``[B?, F, H, W, C]`` -> uint8 middles.

        Accepts RGB (C=3) or single-channel input; returns the same layout.
        """
        squeeze = preceding_u8.ndim == 4
        gray = getattr(self.model, "c_dim", 3) == 1 and preceding_u8.shape[-1] == 3
        if self._host is not None:
            pred = self._host(T, self._frames(preceding_u8, gray), self._frames(following_u8, gray))["pred"]
        else:
            pred = self.forward(T, self._to_model(preceding_u8, gray), self._to_model(following_u8, gray))
            pred = pred.float().cpu().numpy()
        out = np.clip((pred + 1.0) / 2.0, 0.0, 1.0) * 255.0
        out = np.round(out).astype(np.uint8)
        if out.shape[-1] == 3:
            out = out[..., ::-1]  # BGR -> RGB
        return out[0] if squeeze else out

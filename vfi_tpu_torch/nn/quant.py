"""int8 serving convolutions (counterpart of ``vfi_tpu/nn/quant.py``).

``VFI_INT8`` (read by ``models.registry.create_model``) swaps every shared
``layers.Conv`` of a model for :class:`QConv`, as vfi_tpu's ``Conv`` helper
does: ``1`` is dynamic (per-call activation scales), ``2`` static
(calibrated scales); SCT's 1x1 ``proj`` (``transformer.Conv1x1``), VGG16 and
the discriminator keep float convs.  Both schemes are symmetric:

  * weights: a per-output-channel scale ``amax(|w|) / 127`` (floor 1e-12;
    as XLA compiles it, :data:`INV_127`) and
    ``clamp(round(w / scale), -127, 127)``, requantized from the float params
    (cached while a weight is unchanged), so the state_dict is the float
    model's;
  * activations: dynamic, one scale ``amax(|x|) / 127`` over the whole input
    of the call, reduced on the device; static, ``act_amax / 127`` of a
    per-layer float32 scalar that :func:`calibrate` records as a running max
    of ``|x|``, read after this call's update.  ``act_amax`` is a buffer
    outside the state_dict, kept float32 when the model is cast;
    :func:`act_amax_state` and :func:`load_act_amax` read and set them
    (``utils.params.quant_from_jax`` converts vfi_tpu's ``"quant"``
    collection).  Calibration starts from zero, as vfi_tpu's docstring says
    (vfi_tpu's predict CLI starts from the amax of its random-init forward).

The conv is int8 x int8 with int32 sums, dequantized as
``float(acc) * (x_scale * w_scale[c]) + b`` in float32 and cast to x's dtype
(``ops/qconv.py``: plain versions on the CPU; on CUDA one hand-written
kernel a call, the activation quantize fused into it).
Serving only: the rounding has a zero gradient, and the training
environments refuse ``VFI_INT8``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.qconv import n_tile, pack_weight, padded_channels, qconv_int8
from .discriminator import SNDiscriminator
from .layers import Conv
from .vgg import VGG16Features

EPS = 1e-12
# vfi_tpu divides by 127.0 in its source; XLA compiles the division by that
# constant as a product with its float32 reciprocal, and vfi_tpu always runs
# compiled, so its scales are amax * float32(1/127), for some amax one ulp
# off amax / 127.
INV_127 = float(np.float32(1.0 / 127.0))


def quantize_symmetric(a: torch.Tensor, dims, eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over ``dims`` (the amax's reduction axes;
    all axes: per tensor, all but the channel axis: per channel): returns
    ``(q int8, scale float32)``, the scale with the reduced axes kept.  The
    scale is ``amax * INV_127``, vfi_tpu's compiled arithmetic."""
    a32 = a.float()
    scale = torch.clamp_min(torch.amax(a32.abs(), dim=dims, keepdim=True) * INV_127, eps)
    return torch.clamp(torch.round(a32 / scale), -127, 127).to(torch.int8), scale


def _abs_max(x: torch.Tensor) -> torch.Tensor:
    """max(|x|) over the whole tensor as a float32 scalar on x's device."""
    lo, hi = torch.aminmax(x)
    return torch.maximum(-lo, hi).float()


class QConv(Conv):
    """A ``layers.Conv`` (the same ``weight`` and ``bias``) computed in int8.

    Made from a ``Conv`` in place by :func:`quantize_convs`.  ``static`` reads
    its activation scale from ``act_amax``; ``calibrating`` (set by
    :func:`calibrate`) updates it with each input's ``max|x|`` first.
    """

    static: bool
    calibrating: bool

    def _init_quant(self, static: bool) -> None:
        self.static = static
        self.calibrating = False
        self.register_buffer("act_amax", torch.zeros((), dtype=torch.float32, device=self.weight.device),
                             persistent=False)
        self._wq = None  # (key, wq [Co, k, k, Cp] int8, w_scale [Co] float32)
        self._packed = None  # (key, wq repacked for the CUDA kernel)

    def _apply(self, fn, recurse=True):
        # Module.to casts floating buffers; the amax stays float32 (vfi_tpu
        # keeps its "quant" collection in float32 beside bfloat16 params).
        amax = self._buffers.pop("act_amax")
        try:
            super()._apply(fn, recurse)
        finally:
            self._buffers["act_amax"] = amax.to(self.weight.device)
        self._wq = self._packed = None
        return self

    def quantized_weight(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(wq [Co, k, k, Cp] int8, w_scale [Co] float32)`` of the current
        weight, channels zero-padded to the conv kernel's granule."""
        w = self.weight
        key = (w.data_ptr(), w._version, w.dtype, w.device)
        if self._wq is None or self._wq[0] != key:
            q, scale = quantize_symmetric(w.detach(), dims=(1, 2, 3))
            q = q.permute(0, 2, 3, 1)
            q = nn.functional.pad(q, (0, padded_channels(q.shape[-1]) - q.shape[-1])).contiguous()
            self._wq = (key, q, scale.reshape(-1))
        return self._wq[1], self._wq[2]

    def packed_weight(self) -> torch.Tensor:
        """The current ``wq`` as the CUDA kernel reads it (``ops.qconv.pack_weight``),
        repacked once per weight version."""
        wq, _ = self.quantized_weight()
        if self._packed is None or self._packed[0] != self._wq[0]:
            self._packed = (self._wq[0], pack_weight(wq, n_tile(wq.shape[0])))
        return self._packed[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.static:
            if self.calibrating:
                self.act_amax.copy_(torch.maximum(self.act_amax, _abs_max(x)))
            amax = self.act_amax
        else:
            amax = _abs_max(x)
        x_scale = torch.clamp_min(amax * INV_127, EPS)
        wq, w_scale = self.quantized_weight()
        packed = self.packed_weight() if x.device.type == "cuda" else None
        return qconv_int8(x, x_scale, wq, x_scale * w_scale, self.bias.detach().float(), x.dtype, packed)


def _convs(module: nn.Module, prefix: str = "") -> Iterator[Tuple[str, nn.Module]]:
    """Every ``layers.Conv`` (or ``QConv``) under ``module`` by its module path,
    leaving out VGG16 and the discriminator."""
    for name, child in module.named_children():
        path = f"{prefix}{name}"
        if isinstance(child, Conv):
            yield path, child
        elif not isinstance(child, (VGG16Features, SNDiscriminator)):
            yield from _convs(child, path + ".")


def quantize_convs(model: nn.Module, static: bool) -> nn.Module:
    """Make every shared ``layers.Conv`` of ``model`` a :class:`QConv`, in
    place (dynamic scales, or static ones when ``static``); returns ``model``."""
    for _, conv in _convs(model):
        conv.__class__ = QConv
        conv._init_quant(static)
    return model


def qconvs(model: nn.Module) -> Dict[str, QConv]:
    return {path: m for path, m in _convs(model) if isinstance(m, QConv)}


@contextlib.contextmanager
def calibrate(model: nn.Module):
    """Inside, every forward of ``model`` updates the ``act_amax`` of its
    static ``QConv`` modules with the running max of ``|x|``, from zero."""
    convs = [m for m in qconvs(model).values() if m.static]
    for m in convs:
        m.act_amax.zero_()
        m.calibrating = True
    try:
        yield model
    finally:
        for m in convs:
            m.calibrating = False


def act_amax_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``{"<module path>.act_amax": float32 scalar}`` of every static QConv."""
    return {f"{path}.act_amax": m.act_amax for path, m in qconvs(model).items() if m.static}


def load_act_amax(model: nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """Set every static QConv's ``act_amax`` from ``state`` (as
    :func:`act_amax_state` gives it); the keys must match exactly."""
    have = act_amax_state(model)
    if set(have) != set(state):
        raise KeyError(f"act_amax keys differ: missing {sorted(set(have) - set(state))}, "
                       f"unexpected {sorted(set(state) - set(have))}")
    for key, t in have.items():
        t.copy_(torch.as_tensor(state[key], dtype=torch.float32))

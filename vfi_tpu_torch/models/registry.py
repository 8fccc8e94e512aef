"""Model registry (counterpart of ``vfi_tpu/models/registry.py``): all 30 of
vfi_tpu's keys.  The two legacy SCT classes have no key and are reached by a
JSON spec, as in vfi_tpu.  ``OFFillInModel`` is a host model
(``models/optical_flow.py``): not a torch module, no weights, served by its
``host_forward``.

A model is named by a registry key, by a JSON file, or by a JSON literal,
as in vfi_tpu: ``{"class": name, "args": [...], "kwargs": {...}}`` (the
reference's models_as_files/example.json schema).  Python callers may also
pass that spec as a dict, where ``args`` and ``kwargs`` may be left out.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Union

from ..nn.quant import quantize_convs
from .fill_in import (BidirectionalSimpleAverageFillInModel, BidirectionalTimeWeightedAverageFillInModel,
                      MCNetFillInModel, TAIFillInModel, TimeWeightedPFFillInModel, TWIFillInModel)
from .legacy_sct import SCTSkipConFillInModel, SCTSuperSkipConFillInModel
from .optical_flow import OFFillInModel
from .sct import SCT_CLASSES
from .slomo import SloMoFillInModel

_CLASSES = {cls.__name__: cls for cls in (
    TAIFillInModel, TWIFillInModel, BidirectionalSimpleAverageFillInModel,
    BidirectionalTimeWeightedAverageFillInModel, MCNetFillInModel, TimeWeightedPFFillInModel, SloMoFillInModel,
    *SCT_CLASSES.values(), SCTSkipConFillInModel, SCTSuperSkipConFillInModel, OFFillInModel)}


def _kth(cls: str, c_dim: int, num_block: int) -> Dict[str, Any]:
    return {"class": cls, "kwargs": dict(gf_dim=64, c_dim=c_dim, feature_size=3, ks=51, num_block=num_block)}


def _mcnet(cls: str, c_dim: int) -> Dict[str, Any]:
    return {"class": cls, "kwargs": dict(gf_dim=64, c_dim=c_dim, feature_size=3)}


_REGISTRY: Dict[str, Dict[str, Any]] = {
    "TAI_gray": _kth("TAIFillInModel", 1, 5),
    "TAI_color": _kth("TAIFillInModel", 3, 4),
    "OFFillInModel": {"class": "OFFillInModel", "kwargs": {}},
    "TimeWeightedInterpolationFillInModel_gray": _kth("TWIFillInModel", 1, 5),
    "TimeWeightedInterpolationFillInModel_color": _kth("TWIFillInModel", 3, 4),
    "MCNet_gray": _mcnet("MCNetFillInModel", 1),
    "MCNet_color": _mcnet("MCNetFillInModel", 3),
    "BidirectionalSimpleAverageFillInModel_gray": _mcnet("BidirectionalSimpleAverageFillInModel", 1),
    "BidirectionalSimpleAverageFillInModel_color": _mcnet("BidirectionalSimpleAverageFillInModel", 3),
    "BidirectionalTimeWeightedAverageFillInModel_gray": _mcnet("BidirectionalTimeWeightedAverageFillInModel", 1),
    "BidirectionalTimeWeightedAverageFillInModel_color": _mcnet("BidirectionalTimeWeightedAverageFillInModel", 3),
    "TimeWeightedPFFillInModel": {"class": "TimeWeightedPFFillInModel", "kwargs": {}},
    "SloMoFillInModel_gray": {"class": "SloMoFillInModel", "kwargs": dict(base_dim=32, c_dim=1)},
    "SloMoFillInModel_color": {"class": "SloMoFillInModel", "kwargs": dict(base_dim=32, c_dim=3)},
}
# The SCT family: every variant in _gray (c_dim=1) and _color (c_dim=3).
for _name, _cls in SCT_CLASSES.items():
    for _c_dim, _suffix in ((1, "_gray"), (3, "_color")):
        _REGISTRY[_name + _suffix] = {"class": _cls.__name__, "kwargs": dict(
            c_dim=_c_dim, num_blocks=2, num_heads=3, d_v=256, d_ff=2048)}

ModelSpec = Union[str, Dict[str, Any]]


def model_keys() -> list[str]:
    return sorted(_REGISTRY)


def _json_spec(info: Any) -> Dict[str, Any]:
    """A JSON model spec, held to vfi_tpu's schema."""
    if not (isinstance(info, dict) and isinstance(info.get("class"), str) and isinstance(info.get("args"), list)
            and isinstance(info.get("kwargs"), dict)):
        raise ValueError(f'a JSON model key must be {{"class": str, "args": list, "kwargs": dict}}, got {info!r}')
    return info


def model_config(model: ModelSpec) -> Dict[str, Any]:
    """A registry key, a JSON file path, a JSON literal, or a dict spec, as a spec."""
    if isinstance(model, dict):
        spec = model
    elif model in _REGISTRY:
        return _REGISTRY[model]
    elif os.path.isfile(model):
        with open(model) as f:
            spec = _json_spec(json.load(f))
    else:
        try:
            info = json.loads(model)
        except ValueError:
            raise KeyError(
                f"Unknown model key {model!r}; not a registry key, file, or JSON literal. "
                f"Known keys: {model_keys()}"
            ) from None
        spec = _json_spec(info)
    if spec.get("class") not in _CLASSES:
        raise KeyError(f"unknown model class {spec.get('class')!r}; known: {sorted(_CLASSES)}")
    return spec


def is_host_model(model: ModelSpec) -> bool:
    """Whether the model runs on the host by its ``host_forward`` (no weights, no device)."""
    return hasattr(_CLASSES[model_config(model)["class"]], "host_forward")


def create_model(model: ModelSpec):
    """Build a model (on the CPU, xavier-initialised) from a key or a spec.

    ``VFI_INT8``, read here as vfi_tpu's ``Conv`` helper reads it, makes every
    shared conv an int8 ``nn.quant.QConv``: ``1`` with dynamic scales, ``2``
    with static ones (calibrated by ``nn.quant.calibrate``); anything else
    leaves the convs float.  The state_dict is the same either way.  A host
    model (``host_forward``) has no convs and ignores it, as in vfi_tpu."""
    cfg = model_config(model)
    m = _CLASSES[cfg["class"]](*cfg.get("args", []), **cfg.get("kwargs", {}))
    mode = os.environ.get("VFI_INT8", "0")
    if mode in ("1", "2") and not hasattr(m, "host_forward"):
        quantize_convs(m, static=mode == "2")
    return m

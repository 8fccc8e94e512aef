"""Reference (PyTorch) checkpoints into port state_dicts (counterpart of
``vfi_tpu/utils/torch_import.py``).

The upstream project ships pretrained ``model_best.ckpt`` snapshots whose
``generator`` entry is a torch ``state_dict`` (saved by
src/environments/environments.py:178-219).  This module maps those tensors
onto the port's modules, so that reference-trained weights are served (and
fine-tuned) here.

The name maps are vfi_tpu's: each maps a reference module path (owning
``.weight`` / ``.bias``) to a flax module path and a converter kind.  The
port's modules carry the flax names (``utils/params.py``), so the target of
``"mcnet/motion_enc/dyn1"`` is ``mcnet.motion_enc.dyn1.weight`` / ``.bias``.
Both sides are NCHW, so conv and linear weights pass through unchanged; the
reference DecCnn's stride-1 ``nn.ConvTranspose2d`` (IOHW, pad 1;
src/models/mcnet/mcnet.py:188-238) is a SAME cross-correlation with the
spatially flipped kernel and the in/out axes swapped, so it becomes OIHW.

Name maps cover the generator families that have trainable checkpoints:
  * TAIFillInModel            (attrs generator/merge_residual*/kernelnet,
                               src/models/tai/tai.py:38-50)
  * TimeWeightedInterpolation (attrs mcnet/merge_residual*/interp_net,
                               src/models/twi/twi.py:41-49)
  * bi-TWA / bi-SA / MCNet    (single attr generator,
                               src/models/bi_twa/bi_twa.py:23, bi_sa.py:18,
                               mcnet.py:301-320)
  * Super SloMo               (src/models/slomo/slomo.py:289-371; serve it
                               with ``warp_mode="torch03"``)

The reference's dead full-resolution ``merge_residual1`` (computed but never
consumed, tai.py:93 vs :226) has no module in the port
(``nn/kernelnet.py``); its weights are reported in ``ImportReport.skipped``
rather than silently dropped.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch


def _same(w: np.ndarray) -> np.ndarray:
    return w


def _deconv_w(w: np.ndarray) -> np.ndarray:
    return w[:, :, ::-1, ::-1].transpose(1, 0, 2, 3)  # IOHW, flipped in H and W -> OIHW


_CONVERTERS: Dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "conv": _same,
    "deconv": _deconv_w,
    "linear": _same,
}

# A name map entry: reference module path (owning .weight/.bias) ->
# (flax module path with '/' separators, converter kind).
NameMap = Dict[str, Tuple[str, str]]


def mcnet_name_map(prefix: str = "generator.", dest: str = "mcnet/") -> NameMap:
    """Reference->flax names for one MCNet (src/models/mcnet/mcnet.py:352-378)."""
    m: NameMap = {
        f"{prefix}motion_enc.dyn_conv1.0": (f"{dest}motion_enc/dyn1", "conv"),
        f"{prefix}motion_enc.dyn_conv2.1": (f"{dest}motion_enc/dyn2", "conv"),
        f"{prefix}motion_enc.dyn_conv3.1": (f"{dest}motion_enc/dyn3", "conv"),
        f"{prefix}conv_lstm_cell.conv": (f"{dest}conv_lstm/gates", "conv"),
    }
    for t, fl in (
        ("cont_conv1.0", "c1a"),
        ("cont_conv1.2", "c1b"),
        ("cont_conv2.1", "c2a"),
        ("cont_conv2.3", "c2b"),
        ("cont_conv3.1", "c3a"),
        ("cont_conv3.3", "c3b"),
        ("cont_conv3.5", "c3c"),
    ):
        m[f"{prefix}content_enc.{t}"] = (f"{dest}content_enc/{fl}", "conv")
    for i, fl in ((0, "comb1"), (2, "comb2"), (4, "comb3")):
        m[f"{prefix}comb_layers.h_comb.{i}"] = (f"{dest}comb_layers/{fl}", "conv")
    for n in (1, 2, 3):
        m[f"{prefix}residual{n}.res.0"] = (f"{dest}residual{n}/res1", "conv")
        m[f"{prefix}residual{n}.res.2"] = (f"{dest}residual{n}/res2", "conv")
    # DecCnn: stride-1 ConvTranspose2d chains (mcnet.py:188-238)
    for stage, names in (("dec3", ("d3a", "d3b", "d3c")), ("dec2", ("d2a", "d2b")), ("dec1", ("d1a", "d1b"))):
        for j, fl in enumerate(names):
            m[f"{prefix}dec_cnn.{stage}.{2 * j}"] = (f"{dest}dec_cnn/{fl}", "deconv")
    return m


def kernelnet_name_map(prefix: str, num_block: int, layers: int) -> NameMap:
    """Reference->flax names for the TAI/TWI interpolation U-Net
    (src/models/tai/tai.py:157-177 module lists; sequence indices follow
    create_basic_conv_block / create_1d_kernel_generator_block)."""
    m: NameMap = {}
    for j in range(num_block - 3):
        for l in range(layers):
            m[f"{prefix}moduleConv.{j}.{2 * l}"] = (f"kernelnet/enc{3 + j}/conv{l}", "conv")
    for i in range(num_block - 1):
        for l in range(layers):
            m[f"{prefix}moduleDeconv.{i}.{2 * l}"] = (f"kernelnet/dec{i}/conv{l}", "conv")
        m[f"{prefix}moduleUpsample.{i}.1"] = (f"kernelnet/up{i}", "conv")
    for head in ("Vertical1", "Vertical2", "Horizontal1", "Horizontal2"):
        fl = head.lower()
        for l in range(layers - 1):
            m[f"{prefix}module{head}.{2 * l}"] = (f"kernelnet/{fl}/conv{l}", "conv")
        # conv -> ks channels at seq index 2*(layers-1); the post-upsample conv
        # sits after [relu, Upsample] at index 2*layers + 1 (tai.py:266-286)
        m[f"{prefix}module{head}.{2 * (layers - 1)}"] = (f"kernelnet/{fl}/to_ks", "conv")
        m[f"{prefix}module{head}.{2 * layers + 1}"] = (f"kernelnet/{fl}/post_up", "conv")
    return m


def slomo_name_map() -> NameMap:
    """Reference->flax names for Super SloMo (src/models/slomo/slomo.py:289-371).

    Both UNets: encoder stages ``enc1..enc6`` are Sequentials with convs at
    indices (0, 2) for enc1 and (1, 3) for the rest (MaxPool2d at 0,
    slomo.py:40-85); decoder stages ``dec1..dec5`` have convs at (0, 2) and a
    final 1x1 ``output`` conv (slomo.py:115-158).
    """
    m: NameMap = {}
    for unet in ("compute", "refine"):
        for i in range(6):
            a, b = (0, 2) if i == 0 else (1, 3)
            m[f"generator.{unet}_enc.enc{i + 1}.{a}"] = (f"{unet}_enc/e{i}a", "conv")
            m[f"generator.{unet}_enc.enc{i + 1}.{b}"] = (f"{unet}_enc/e{i}b", "conv")
        for i in range(5):
            m[f"generator.{unet}_dec.dec{i + 1}.0"] = (f"{unet}_dec/d{i}a", "conv")
            m[f"generator.{unet}_dec.dec{i + 1}.2"] = (f"{unet}_dec/d{i}b", "conv")
        m[f"generator.{unet}_dec.output"] = (f"{unet}_dec/out", "conv")
    return m


def merge_residual_name_map() -> NameMap:
    m: NameMap = {}
    for n in (2, 3):
        m[f"merge_residual{n}.res.0"] = (f"merge_residual{n}/res1", "conv")
        m[f"merge_residual{n}.res.2"] = (f"merge_residual{n}/res2", "conv")
    return m


def name_map_for(model_kind: str, num_block: int = 5, layers: int = 3) -> NameMap:
    """Full reference->flax name map for a generator ``state_dict``.

    :param model_kind: one of 'tai', 'twi', 'mcnet', 'bidirectional', 'slomo'
        ('bidirectional' covers bi-TWA / bi-SA: a bare shared MCNet).
    """
    if model_kind == "tai":
        m = mcnet_name_map("generator.")
        m.update(merge_residual_name_map())
        m.update(kernelnet_name_map("kernelnet.", num_block, layers))
    elif model_kind == "twi":
        # TWI names its submodules mcnet/interp_net (twi.py:43-49)
        m = mcnet_name_map("mcnet.")
        m.update(merge_residual_name_map())
        m.update(kernelnet_name_map("interp_net.", num_block, layers))
    elif model_kind in ("mcnet", "bidirectional"):
        m = mcnet_name_map("generator.")
    elif model_kind == "slomo":
        m = slomo_name_map()
    else:
        raise ValueError(f"unknown model_kind {model_kind!r}")
    return m


@dataclass
class ImportReport:
    converted: int = 0
    skipped: list = field(default_factory=list)  # reference keys with no home in the port

    def __str__(self):
        s = f"{self.converted} tensors converted"
        if self.skipped:
            s += f"; skipped (no port equivalent): {sorted(self.skipped)}"
        return s


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def import_generator_state_dict(
    state_dict: Mapping[str, np.ndarray],
    model_kind: str,
    *,
    num_block: int = 5,
    layers: int = 3,
) -> Tuple[Dict[str, torch.Tensor], ImportReport]:
    """Convert a reference generator ``state_dict`` (numpy or CPU tensor
    values) into the port model's state_dict (float32, CPU).

    Raises KeyError listing every expected-but-missing reference key; unknown
    keys are collected in the report (the only legitimate ones are the dead
    ``merge_residual1`` weights).
    """
    nmap = name_map_for(model_kind, num_block, layers)
    state: Dict[str, torch.Tensor] = {}
    report = ImportReport()
    sd = dict(state_dict)

    missing = []
    for tkey, (fpath, kind) in nmap.items():
        wkey, bkey = f"{tkey}.weight", f"{tkey}.bias"
        if wkey not in sd:
            missing.append(wkey)
            continue
        dest = fpath.replace("/", ".")
        state[f"{dest}.weight"] = _tensor(_CONVERTERS[kind](np.asarray(sd.pop(wkey), np.float32)))
        report.converted += 1
        if bkey in sd:
            state[f"{dest}.bias"] = _tensor(np.asarray(sd.pop(bkey), np.float32))
            report.converted += 1
    if missing:
        raise KeyError(f"reference state_dict is missing expected keys: {missing}")

    report.skipped = [k for k in sd if not k.endswith("num_batches_tracked")]
    return state, report


def import_discriminator_state_dict(
    state_dict: Mapping[str, np.ndarray], df_dim: int
) -> Tuple[Dict[str, torch.Tensor], ImportReport]:
    """Convert a reference SNDiscriminator ``state_dict`` into the port
    discriminator's state_dict (float32, CPU), ``u`` buffers included.

    Reference layout (SNDiscriminator.py:95-159): ``conv_layers.{0,2,4,6}``
    SNConv2d + ``linear_layer`` SNLinear.  The linear weight's input axis runs
    over NCHW features, (c, h, w)-major; the port's head flattens NHWC
    features, (h, w, c)-major (``nn/discriminator.py``), so that axis is
    permuted.  Power-iteration ``u`` buffers are carried over when present
    (shape [1, out] -> [out]) as ``conv{i}.sn.u`` / ``head.sn.u``.
    """
    sd = dict(state_dict)
    state: Dict[str, torch.Tensor] = {}
    report = ImportReport()

    def take(key):
        if key not in sd:
            raise KeyError(f"reference discriminator state_dict is missing {key}")
        report.converted += 1
        return np.asarray(sd.pop(key), np.float32)

    def take_u(key, dest):
        if key in sd:
            state[dest] = _tensor(np.asarray(sd.pop(key), np.float32).reshape(-1))

    for i, seq in enumerate((0, 2, 4, 6)):
        state[f"conv{i}.weight"] = _tensor(take(f"conv_layers.{seq}.weight"))
        state[f"conv{i}.bias"] = _tensor(take(f"conv_layers.{seq}.bias"))
        take_u(f"conv_layers.{seq}.u", f"conv{i}.sn.u")

    lw = take("linear_layer.weight")  # [1, in] over (c, h, w)-major features
    C = df_dim * 8
    hw = lw.shape[1] // C
    side = int(round(hw**0.5))
    if side * side != hw:
        raise ValueError(f"non-square conv output ({hw}) in linear head import")
    state["head.weight"] = _tensor(lw.reshape(1, C, side, side).transpose(0, 2, 3, 1).reshape(1, -1))
    state["head.bias"] = _tensor(take("linear_layer.bias"))
    take_u("linear_layer.u", "head.sn.u")

    report.skipped = [k for k in sd if not k.endswith("num_batches_tracked")]
    return state, report


def model_kind_for_key(model_key: str) -> str:
    """Map a registry model_key / class name to an importer kind."""
    key = model_key
    if key.startswith("{") or key.endswith(".json"):
        raise ValueError("pass the resolved class name for JSON model keys")
    lowered = key.lower()
    if "slomo" in lowered:
        return "slomo"
    if "twi" in lowered or "timeweightedinterpolation" in lowered:
        return "twi"
    if "tai" in lowered:
        return "tai"
    if lowered.startswith("bi_") or "simpleaverage" in lowered or "timeweightedaverage" in lowered:
        return "bidirectional"
    if "mcnet" in lowered:
        return "mcnet"
    raise ValueError(f"no torch importer for model key {model_key!r}")

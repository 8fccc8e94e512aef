"""Weights across the two packages.

Port submodules carry vfi_tpu's flax names, so the flax path
``("mcnet", "motion_enc", "dyn1", "kernel")`` is the state_dict key
``mcnet.motion_enc.dyn1.weight``.  Conv kernels go from flax HWIO to torch
OIHW, dense kernels ``[in, out]`` to ``[out, in]``; biases go as they are.
The discriminator's ``"sn"`` collection maps to its ``u`` buffers:
``("conv0", "sn", "u")`` is ``conv0.sn.u``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ..models.registry import ModelSpec, create_model
from ..nn.discriminator import SNDiscriminator

Path = Tuple[str, ...]


def _flatten(tree: Mapping[str, Any], prefix: Path = ()) -> Dict[Path, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = np.asarray(v)
    return flat


def _kernel_to_torch(a: np.ndarray) -> np.ndarray:
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T  # HWIO -> OIHW, [in, out] -> [out, in]


def params_from_jax(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """vfi_tpu ``params`` (nested dict of arrays) -> port state_dict (float32, CPU)."""
    state = {}
    for path, a in _flatten(flax_params).items():
        a = np.asarray(a, np.float32)
        leaf = {"kernel": "weight", "bias": "bias"}[path[-1]]
        if path[-1] == "kernel":
            a = _kernel_to_torch(a)
        state[".".join(path[:-1] + (leaf,))] = torch.from_numpy(np.array(a, np.float32, order="C"))
    return state


def disc_variables_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """vfi_tpu discriminator variables ``{"params": ..., "sn": ...}`` -> the
    port discriminator's state_dict (float32, CPU), ``u`` buffers included
    where ``"sn"`` is given."""
    state = params_from_jax(variables["params"])
    for path, a in _flatten(variables.get("sn", {})).items():
        state[".".join(path)] = torch.from_numpy(np.array(a, np.float32, order="C"))
    return state


def _flax_shapes(module: torch.nn.Module) -> Dict[str, Dict[Path, Tuple[int, ...]]]:
    """Every flax path of a port module (built on the meta device) and its
    flax-layout shape, by collection: ``"params"`` and, for buffers, ``"sn"``."""
    shapes: Dict[str, Dict[Path, Tuple[int, ...]]] = {"params": {}, "sn": {}}
    for key, t in module.state_dict().items():
        *mod, leaf = key.split(".")
        shape = tuple(t.shape)
        if leaf == "weight":
            flax_shape = tuple(shape[i] for i in (2, 3, 1, 0)) if len(shape) == 4 else shape[::-1]
            shapes["params"][tuple(mod) + ("kernel",)] = flax_shape
        elif leaf == "bias":
            shapes["params"][tuple(mod) + ("bias",)] = shape
        else:
            shapes["sn"][tuple(mod) + (leaf,)] = shape
    return shapes


def _set(tree: Dict[str, Any], path: Path, a: np.ndarray) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = a.astype(np.float32)


def _draw_params(shapes: Dict[Path, Tuple[int, ...]], rng: np.random.RandomState) -> Dict[str, Any]:
    """Kernels He-normal and biases small normals, in sorted path order; the
    kernel heads' outputs (``post_up``) as ``random_jax_params`` says."""
    tree: Dict[str, Any] = {}
    for path, shape in sorted(shapes.items()):
        if path[-1] == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            std = np.sqrt(2.0 / fan_in)
            if path[-2] == "post_up":
                std = 0.5 / shape[-1] / np.sqrt(fan_in)
            a = rng.standard_normal(shape) * std
        else:
            a = rng.standard_normal(shape) * 0.01
            if path[-2] == "post_up":  # a kernel head's output: taps sum to about 1
                a = a + 1.0 / shape[0]
        _set(tree, path, a)
    return tree


def random_jax_params(model: ModelSpec, seed: int) -> Dict[str, Any]:
    """Random flax-layout params (nested dict of float32 numpy arrays).

    Drawn in sorted path order from one legacy ``np.random.RandomState(seed)``,
    whose stream is frozen, so any machine makes the same weights without JAX.
    Conv kernels are He-normal (std sqrt(2/fan_in)), so activations keep
    their scale through the ReLU stacks and the outputs vary with the inputs
    (xavier weights, the training init, leave the predictions nearly
    constant).  Biases are small normals, so the bias mapping is exercised
    too.  The kernel heads' outputs (``post_up``) have biases centred on 1/ks
    and small weights, so each per-pixel kernel sums to about 1, as trained
    sepconv kernels do.
    """
    with torch.device("meta"):
        m = create_model(model)
    return _draw_params(_flax_shapes(m)["params"], np.random.RandomState(seed))


def random_jax_disc_variables(cfg, H: int, W: int, c_dim: int, seed: int) -> Dict[str, Any]:
    """Random flax-layout discriminator variables ``{"params": ..., "sn": ...}``
    for a ``TrainConfig`` (``disc_window_size``, ``df_dim``, ``Ip``) and
    ``[H, W, c_dim]`` frames.

    Drawn from one legacy ``np.random.RandomState(seed)`` as
    :func:`random_jax_params` draws: the params in sorted path order (conv
    and dense kernels He-normal, biases small normals), then each ``u`` in
    sorted path order (standard normal).
    """
    with torch.device("meta"):
        disc = SNDiscriminator(cfg.disc_window_size, c_dim, (H, W), cfg.df_dim, cfg.Ip)
    shapes = _flax_shapes(disc)
    rng = np.random.RandomState(seed)
    params = _draw_params(shapes["params"], rng)
    sn: Dict[str, Any] = {}
    for path, shape in sorted(shapes["sn"].items()):
        _set(sn, path, rng.standard_normal(shape))
    return {"params": params, "sn": sn}

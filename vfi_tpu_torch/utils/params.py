"""Weights across the two packages.

Port submodules carry vfi_tpu's flax names, so the flax path
``("mcnet", "motion_enc", "dyn1", "kernel")`` is the state_dict key
``mcnet.motion_enc.dyn1.weight``.  Conv kernels go from flax HWIO to torch
OIHW, dense kernels ``[in, out]`` to ``[out, in]``; a LayerNorm's or
GroupNorm's ``scale`` is its ``weight`` (the only 1-D weights); biases go as
they are.
The discriminator's ``"sn"`` collection maps to its ``u`` buffers:
``("conv0", "sn", "u")`` is ``conv0.sn.u``.  ``params_to_jax`` and
``disc_variables_to_jax`` go back, to nested numpy dicts.  The int8 mode's
``"quant"`` collection maps the same way to the ``act_amax`` of the static
``QConv`` modules (``quant_from_jax``, for ``nn.quant.load_act_amax``):
``("mcnet", "content_enc", "c1a", "act_amax")`` is
``mcnet.content_enc.c1a.act_amax``.  Weights need nothing new, since the int8
mode keeps the float params.

Adam state: optax's ``ScaleByAdamState(count, mu, nu)`` is torch's
per-parameter ``step`` (every parameter at ``count``), ``exp_avg`` and
``exp_avg_sq``; the moments take the kernels' transposes.  Both libraries
put eps outside the square root (optax's ``eps_root`` is 0), so the same
moments give the same update.
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


def _kernel_to_jax(a: np.ndarray) -> np.ndarray:
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T  # OIHW -> HWIO, [out, in] -> [in, out]


def params_from_jax(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """vfi_tpu ``params`` (nested dict of arrays) -> port state_dict (float32, CPU)."""
    state = {}
    for path, a in _flatten(flax_params).items():
        a = np.asarray(a, np.float32)
        leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}[path[-1]]
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


def quant_from_jax(quant: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """vfi_tpu's ``"quant"`` collection (``{..: {"act_amax": scalar}}``) ->
    ``{"<module path>.act_amax": float32 scalar}`` (CPU) for ``nn.quant.load_act_amax``."""
    state = {}
    for path, a in _flatten(quant).items():
        if path[-1] != "act_amax":
            raise KeyError(f"unexpected leaf {'/'.join(path)} in a \"quant\" collection")
        state[".".join(path)] = torch.tensor(float(np.asarray(a, np.float32)), dtype=torch.float32)
    return state


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Port state_dict entries ``*.weight`` / ``*.bias`` -> vfi_tpu ``params``
    (nested dict of float32 numpy arrays).  Other entries (buffers) are left out."""
    tree: Dict[str, Any] = {}
    for key, t in state.items():
        *mod, leaf = key.split(".")
        if leaf not in ("weight", "bias"):
            continue
        a = t.detach().cpu().float().numpy()
        _set(tree, tuple(mod) + (_flax_leaf(leaf, a.ndim),), np.ascontiguousarray(
            _kernel_to_jax(a) if leaf == "weight" and a.ndim > 1 else a))
    return tree


def _flax_leaf(leaf: str, ndim: int) -> str:
    """The flax name of a port parameter: a 1-D weight is a norm's ``scale``."""
    if leaf == "bias":
        return "bias"
    return "scale" if ndim == 1 else "kernel"


def disc_variables_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port discriminator's state_dict -> vfi_tpu variables ``{"params": ..., "sn": ...}``."""
    sn: Dict[str, Any] = {}
    for key, t in state.items():
        if key.split(".")[-1] not in ("weight", "bias"):
            _set(sn, tuple(key.split(".")), t.detach().cpu().float().numpy())
    return {"params": params_to_jax(state), "sn": sn}


def adam_state_from_jax(adam: Mapping[str, Any], names) -> Dict[int, Dict[str, torch.Tensor]]:
    """optax ``ScaleByAdamState`` as a mapping ``{"count", "mu", "nu"}`` -> the
    ``"state"`` of a torch Adam ``state_dict`` over parameters named ``names``
    in the optimizer's order.  A count of 0 (no step taken) is torch's empty state."""
    count = int(np.asarray(adam["count"]))
    if count == 0:
        return {}
    mu, nu = params_from_jax(adam["mu"]), params_from_jax(adam["nu"])
    return {i: {"step": torch.tensor(float(count)), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
            for i, n in enumerate(names)}


def adam_state_to_jax(state: Mapping[int, Mapping[str, torch.Tensor]], names, params: Mapping[str, torch.Tensor]
                      ) -> Dict[str, Any]:
    """The ``"state"`` of a torch Adam ``state_dict`` over parameters named
    ``names`` -> optax ``{"count", "mu", "nu"}`` (numpy).  ``params`` (the
    module's state_dict) gives zero moments' shapes where no step was taken.
    Every parameter must be at the same step, as optax keeps one count."""
    steps = {int(float(s["step"])) for s in state.values()}
    if len(steps) > 1:
        raise ValueError(f"Adam parameters at different steps {sorted(steps)}; optax keeps one count")
    zeros = {n: torch.zeros_like(params[n]) for n in names}
    mu = {n: state[i]["exp_avg"] if i in state else zeros[n] for i, n in enumerate(names)}
    nu = {n: state[i]["exp_avg_sq"] if i in state else zeros[n] for i, n in enumerate(names)}
    return {"count": np.asarray(steps.pop() if steps else 0, np.int32), "mu": params_to_jax(mu),
            "nu": params_to_jax(nu)}


def _flax_shapes(module: torch.nn.Module) -> Dict[str, Dict[Path, Tuple[int, ...]]]:
    """Every flax path of a port module (built on the meta device) and its
    flax-layout shape, by collection: ``"params"`` and, for buffers, ``"sn"``."""
    shapes: Dict[str, Dict[Path, Tuple[int, ...]]] = {"params": {}, "sn": {}}
    for key, t in module.state_dict().items():
        *mod, leaf = key.split(".")
        shape = tuple(t.shape)
        if leaf in ("weight", "bias"):
            flax_shape = tuple(shape[i] for i in (2, 3, 1, 0)) if len(shape) == 4 else shape[::-1]
            shapes["params"][tuple(mod) + (_flax_leaf(leaf, len(shape)),)] = flax_shape
        else:
            shapes["sn"][tuple(mod) + (leaf,)] = shape
    return shapes


def _set(tree: Dict[str, Any], path: Path, a: np.ndarray) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = a.astype(np.float32)


def _draw_params(shapes: Dict[Path, Tuple[int, ...]], rng: np.random.RandomState) -> Dict[str, Any]:
    """Kernels He-normal, norm scales 1 plus small normals and biases small
    normals, in sorted path order; the kernel heads' outputs (``post_up``) as
    ``random_jax_params`` says."""
    tree: Dict[str, Any] = {}
    for path, shape in sorted(shapes.items()):
        if path[-1] == "scale":
            a = 1.0 + rng.standard_normal(shape) * 0.1
        elif path[-1] == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            std = np.sqrt(2.0 / fan_in)
            if path[-2] == "post_up":
                std = 0.5 / shape[-1] / np.sqrt(fan_in)
            elif path[-3:-1] == ("frame_decoder", "d3b"):  # SCT's frame output: keep tanh off its rails
                std *= 0.2
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
    sepconv kernels do.  Norm scales (LayerNorm, GroupNorm) are 1 plus small
    normals.  The SCT frame decoder's output conv (``frame_decoder/d3b``) is
    drawn at a fifth of He's std, so that its tanh is not saturated (at He's
    std 94 % of Bypass's full-width outputs were).
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

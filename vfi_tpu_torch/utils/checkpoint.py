"""Snapshots with the reference's latest/numbered/best layout (counterpart of
``vfi_tpu/utils/checkpoint.py``).

  * ``model_latest.ckpt`` + ``model_%08d.ckpt`` every save_latest_freq
  * ``model_best.ckpt`` on best validation SSIM
  * a snapshot holds the generator, the discriminator with its ``u`` buffers,
    both Adam optimizers, the step, and the counters {updates,
    sum_avg_psnr_err, sum_avg_ssim_err}; a state without a discriminator
    (Super SloMo; vfi_tpu's ``d_params`` is None) has neither it nor its
    optimizer, and a state with a random generator (SCT) adds its state

Each snapshot is a directory, as vfi_tpu's orbax snapshots are, holding one
``torch.save`` file (:data:`PAYLOAD`) of plain tensors and numbers that loads
with ``weights_only=True``:

    {"generator": state_dict, "discriminator": state_dict (u buffers included),
     "g_opt": Adam state_dict, "d_opt": Adam state_dict, "step": int,
     "counters": {name: int | float}, "rng": uint8 tensor}

(``discriminator`` and ``d_opt`` only where the state has a discriminator,
``rng`` only where it has a generator).

``scripts/convert_checkpoint_torch.py`` converts vfi_tpu snapshots to this
layout and back.

Under a launch of several ranks (``parallel/mesh.py``) saving is rank 0's
alone, and nothing here waits on another rank: each rank runs its own
program and only rank 0 calls :func:`save_snapshot`, so a save that waited
on the others would deadlock them (vfi_tpu's ``utils/checkpoint.py`` gives the
same reason).  Rank 0 loads, and ``parallel.replicate_state`` then gives
every rank its state.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

PAYLOAD = "state.pt"


def write_payload(save_dir: str, name: str, payload: Dict[str, Any]) -> None:
    """Write a payload as the snapshot ``save_dir/name`` (a directory), replacing any."""
    path = os.path.abspath(os.path.join(save_dir, name))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f".{PAYLOAD}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, PAYLOAD))


def save_snapshot(save_dir: str, name: str, state, counters: dict) -> None:
    """Save a training state (``train.environments.TrainState``) + scalar
    counters under ``save_dir/name``."""
    payload = {
        "generator": state.generator.state_dict(),
        "g_opt": state.g_opt.state_dict(),
        "step": int(state.step),
        "counters": {k: v.item() if hasattr(v, "item") else v for k, v in counters.items()},
    }
    if state.discriminator is not None:
        payload["discriminator"] = state.discriminator.state_dict()
        payload["d_opt"] = state.d_opt.state_dict()
    if state.rng is not None:
        payload["rng"] = state.rng.get_state()
    write_payload(save_dir, name, payload)


def load_snapshot(save_dir: str, name: str, state: Optional[Any] = None) -> Tuple[Any, dict]:
    """Restore (state, counters), tensors on the CPU.  With a training
    ``state``, the snapshot is loaded into it in place (modules, the
    optimizers' moments and steps, step) and the state is returned; without
    one, the payload is returned.  The running optimizers keep their own
    hyper-parameters (``param_groups``), as vfi_tpu's optax states hold none:
    a resumed run uses its config's (Super SloMo's environment sets its
    learning rate from the restored step at each update).  A snapshot with a
    discriminator loads only into a state with one, and the reverse."""
    path = os.path.abspath(os.path.join(save_dir, name))
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no snapshot at {path}")
    payload = torch.load(os.path.join(path, PAYLOAD), map_location="cpu", weights_only=True)
    if state is None:
        return payload, payload["counters"]
    if (state.discriminator is None) != ("discriminator" not in payload):
        raise ValueError(f"the snapshot at {path} {'has a' if 'discriminator' in payload else 'has no'} discriminator, "
                         f"the training state {'has none' if state.discriminator is None else 'has one'}")
    state.generator.load_state_dict(payload["generator"])
    pairs = [(state.g_opt, payload["g_opt"])]
    if state.discriminator is not None:
        state.discriminator.load_state_dict(payload["discriminator"])
        pairs.append((state.d_opt, payload["d_opt"]))
    for opt, saved in pairs:
        opt.load_state_dict({"state": saved["state"], "param_groups": opt.state_dict()["param_groups"]})
    if state.rng is not None and "rng" in payload:
        state.rng.set_state(payload["rng"])
    state.step = payload["step"]
    return state, payload["counters"]


def has_snapshot(save_dir: str, name: str) -> bool:
    return os.path.isdir(os.path.join(save_dir, name))

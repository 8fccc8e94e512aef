#!/usr/bin/env python3
"""Convert a training snapshot between vfi_tpu (orbax) and vfi_tpu_torch.

    python3 scripts/convert_checkpoint_torch.py to_torch checkpoints/kth_bi-TAI/model_best.ckpt \\
        torch_checkpoints/kth_bi-TAI/model_best.ckpt --model_key TAI_gray
    python3 scripts/convert_checkpoint_torch.py to_jax torch_checkpoints/kth_bi-TAI/model_latest.ckpt \\
        checkpoints/kth_bi-TAI/model_latest.ckpt --model_key TAI_gray --seed 0

Both snapshots are directories with the same names (``model_latest.ckpt``,
``model_%08d.ckpt``, ``model_best.ckpt``).  Converted: the generator and
discriminator weights (HWIO <-> OIHW), the discriminator's spectral-norm
``u`` vectors, both Adam states (optax ``count``/``mu``/``nu`` <-> torch's
per-parameter ``step``/``exp_avg``/``exp_avg_sq``, the moments transposed as
their weights), ``step``, and the counters ``updates``, ``sum_avg_psnr_err``
and ``sum_avg_ssim_err``.  ``--model_key`` names the generator (a registry
key or a JSON model key), whose parameter order the torch Adam state follows.
A Super SloMo state has no discriminator (vfi_tpu's ``d_params``, ``d_sn``
and ``d_opt`` are None; the port's snapshot has neither ``discriminator`` nor
``d_opt``), and its optax state adds the learning-rate schedule's count,
which is Adam's.

vfi_tpu's ``TrainState.rng`` has no counterpart in the port: ``to_torch``
drops it, and ``to_jax`` writes what ``init_state(PRNGKey(--seed))`` would
(and drops the port's ``rng``, an SCT state's torch generator).
optax stores no Adam hyper-parameters, and the port's ``load_snapshot``
restores none: the ``param_groups`` written by ``to_torch`` hold
``TrainConfig``'s defaults only to complete torch's ``state_dict`` layout,
and a resumed run uses its own config's.  Needs both JAX and PyTorch; run on
the CPU (``JAX_PLATFORMS=cpu``).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from vfi_tpu_torch.models.registry import create_model  # noqa: E402
from vfi_tpu_torch.models.slomo import SloMoFillInModel  # noqa: E402
from vfi_tpu_torch.nn.discriminator import SNDiscriminator  # noqa: E402
from vfi_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from vfi_tpu_torch.utils.config import TrainConfig  # noqa: E402
from vfi_tpu_torch.utils.params import (adam_state_from_jax, adam_state_to_jax, disc_variables_from_jax,  # noqa: E402
                                        disc_variables_to_jax, params_from_jax, params_to_jax)

COUNTERS = ("updates", "sum_avg_psnr_err", "sum_avg_ssim_err")


def _layout(model_key):
    """(generator state_dict keys, generator parameter names, discriminator
    state_dict keys, discriminator parameter names, whether the generator
    trains on vfi_tpu's learning-rate schedule), each in the port modules'
    order; the modules are built on the meta device (the names do not depend
    on the discriminator's sizes)."""
    with torch.device("meta"):
        g, d = create_model(model_key), SNDiscriminator(3, 1, (32, 32))
    return (list(g.state_dict()), [n for n, _ in g.named_parameters()],
            list(d.state_dict()), [n for n, _ in d.named_parameters()], isinstance(g, SloMoFillInModel))


def _adam_groups(n_params: int):
    """The ``param_groups`` of the port's Adam (``L2GDLDiscEnvironment._adam``)
    over n parameters, at ``TrainConfig``'s defaults."""
    dummies = [torch.nn.Parameter(torch.zeros(())) for _ in range(n_params)]
    return torch.optim.Adam(dummies, lr=TrainConfig.lr, betas=(TrainConfig.beta1, 0.999),
                            eps=1e-8).state_dict()["param_groups"]


def to_torch_payload(state: dict, counters: dict, model_key) -> dict:
    """A vfi_tpu snapshot's restored ``state`` and ``counters`` (nested dicts
    of numpy arrays) -> the port's snapshot payload."""
    g_keys, g_names, d_keys, d_names, _ = _layout(model_key)
    g_sd = params_from_jax(state["g_params"])
    payload = {
        "generator": {k: g_sd[k] for k in g_keys},
        "g_opt": {"state": adam_state_from_jax(state["g_opt"]["0"], g_names),
                  "param_groups": _adam_groups(len(g_names))},
        "step": int(np.asarray(state["step"])),
        "counters": {k: np.asarray(counters[k]).item() for k in COUNTERS},
    }
    if state.get("d_params") is not None:
        d_sd = disc_variables_from_jax({"params": state["d_params"], "sn": state["d_sn"]})
        payload["discriminator"] = {k: d_sd[k] for k in d_keys}
        payload["d_opt"] = {"state": adam_state_from_jax(state["d_opt"]["0"], d_names),
                            "param_groups": _adam_groups(len(d_names))}
    return payload


def to_jax_state(payload: dict, model_key, seed: int = 0):
    """The port's snapshot payload -> (vfi_tpu ``TrainState``, counters)."""
    import jax
    import jax.numpy as jnp
    import optax

    from vfi_tpu.train.environments import TrainState

    _, g_names, _, d_names, schedule = _layout(model_key)

    def adam(opt, names, sd, schedule=False):
        a = adam_state_to_jax(opt["state"], names, sd)
        tree = jax.tree.map(jnp.asarray, a)
        scale = optax.ScaleByScheduleState(count=tree["count"]) if schedule else optax.EmptyState()
        return (optax.ScaleByAdamState(count=tree["count"], mu=tree["mu"], nu=tree["nu"]), scale)

    disc = {}
    if "discriminator" in payload:
        d_vars = disc_variables_to_jax(payload["discriminator"])
        disc = dict(d_params=jax.tree.map(jnp.asarray, d_vars["params"]), d_sn=jax.tree.map(jnp.asarray, d_vars["sn"]),
                    d_opt=adam(payload["d_opt"], d_names, payload["discriminator"]))
    state = TrainState(
        step=jnp.asarray(payload["step"], jnp.int32),
        g_params=jax.tree.map(jnp.asarray, params_to_jax(payload["generator"])),
        g_opt=adam(payload["g_opt"], g_names, payload["generator"], schedule),
        rng=jax.random.split(jax.random.PRNGKey(seed), 3)[2],  # init_state's s_rng
        **disc,
    )
    return state, dict(payload["counters"])


def read_jax_snapshot(path: str):
    """(state, counters) of a vfi_tpu snapshot directory, as nested dicts of numpy arrays."""
    from vfi_tpu.utils import checkpoint as jckpt

    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no snapshot at {path}")
    payload = jckpt._checkpointer().restore(path)
    return payload["state"], payload["counters"]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], epilog=__doc__.split("\n\n", 2)[2],
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("direction", choices=["to_torch", "to_jax"])
    p.add_argument("src", help="the snapshot to convert (a directory, e.g. checkpoints/NAME/model_best.ckpt)")
    p.add_argument("dst", help="the snapshot to write (a directory; replaced if it exists)")
    p.add_argument("--model_key", required=True, help="the generator's model key (registry key or JSON)")
    p.add_argument("--seed", type=int, default=0,
                   help="to_jax: the rng is what vfi_tpu's init_state(PRNGKey(seed)) writes")
    args = p.parse_args(argv)
    dst_dir, dst_name = os.path.split(os.path.abspath(args.dst))
    if args.direction == "to_torch":
        state, counters = read_jax_snapshot(args.src)
        tckpt.write_payload(dst_dir, dst_name, to_torch_payload(state, counters, args.model_key))
    else:
        from vfi_tpu.utils import checkpoint as jckpt

        src_dir, src_name = os.path.split(os.path.abspath(args.src))
        state, counters = to_jax_state(tckpt.load_snapshot(src_dir, src_name)[0], args.model_key, args.seed)
        jckpt.save_snapshot(dst_dir, dst_name, state, counters)
    print(f"{args.direction}: {args.src} -> {args.dst}")


if __name__ == "__main__":
    main()

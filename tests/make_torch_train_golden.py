"""Write tests/torch_golden_train_tai_gray.npz: two JAX bi-TAI training steps at full width.

    JAX_PLATFORMS=cpu python tests/make_torch_train_golden.py

Runs vfi_tpu's TAIEnvironment at the TAI_gray configuration (gf=64, ks=51,
num_block=5, gray 128x128, K=F=T=5, TrainConfig defaults) on the CPU in
float32 with B=2, from the weights, batch and projection vectors of
``chip_smoke.train_golden_setup()``.  Stores the G and D loss terms of
steps 1 and 2 and, for every G and D parameter, ``<grad, r>`` of the step-1
gradient (``jax.value_and_grad`` of the two losses) with its projection
vector, so ``chip_smoke.py`` holds the port on the GPU against it without
JAX.  Not collected by pytest.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from vfi_tpu.models.registry import create_model  # noqa: E402
from vfi_tpu.nn.discriminator import SNDiscriminator  # noqa: E402
from vfi_tpu.train import environments as jenvs  # noqa: E402
from vfi_tpu.utils.config import TrainConfig  # noqa: E402
from vfi_tpu_torch.utils.params import disc_variables_from_jax, params_from_jax  # noqa: E402

OUT = os.path.join(REPO, "tests", "torch_golden_train_tai_gray.npz")


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    cfg = chip_smoke.TRAIN_GOLDEN
    K, T, F = cfg["K"], cfg["T"], cfg["F"]
    port_cfg, g_params, d_vars, targets, r_g, r_d = chip_smoke.train_golden_setup(cfg)
    train_cfg = TrainConfig(K=K, T=T, F=F)
    assert all(getattr(train_cfg, f) == getattr(port_cfg, f) for f in port_cfg.__dataclass_fields__)

    env = jenvs.create_training_environment(create_model(cfg["model_key"]), train_cfg)
    env.discriminator = SNDiscriminator(window_size=train_cfg.disc_window_size, df_dim=train_cfg.df_dim,
                                        Ip=train_cfg.Ip)
    gp, dp, dsn = (jax.tree.map(jnp.asarray, t) for t in (g_params, d_vars["params"], d_vars["sn"]))
    state = jenvs.TrainState(step=jnp.zeros((), jnp.int32), g_params=gp, g_opt=env.g_tx().init(gp),
                             d_params=dp, d_sn=dsn, d_opt=env.d_tx().init(dp), rng=jax.random.PRNGKey(0))

    g_fn = jax.jit(jax.value_and_grad(env._g_loss, has_aux=True), static_argnums=(5, 6, 7))
    (_, (out, _)), g_grads = g_fn(gp, dp, dsn, state.rng, state.step, K, T, F, targets)
    d_fn = jax.jit(jax.value_and_grad(env._d_loss, has_aux=True), static_argnums=(3, 4, 5))
    _, d_grads = d_fn(dp, dsn, out["pred"], K, T, F, targets)
    g_proj = chip_smoke.grad_projections(params_from_jax(g_grads), r_g)
    d_proj = chip_smoke.grad_projections(disc_variables_from_jax({"params": d_grads}), r_d)
    del out, g_grads, d_grads

    terms = []
    for step in range(cfg["steps"]):
        state, m = env.train_step(state, K, T, F, targets)
        terms.append([float(m[n]) for n in chip_smoke.TERM_NAMES])
        print(f"step {step + 1}: " + ", ".join(f"{n}={v:.6g}" for n, v in zip(chip_smoke.TERM_NAMES, terms[-1])))

    np.savez_compressed(
        OUT, **{k: np.asarray(v) for k, v in cfg.items()},
        term_names=np.array(chip_smoke.TERM_NAMES), terms=np.array(terms, np.float64),
        g_keys=np.array(list(r_g)), g_proj=g_proj, d_keys=np.array(list(r_d)), d_proj=d_proj,
    )
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    torch.set_num_threads(1)  # the port is only used here to map arrays between layouts
    main()

"""Write tests/torch_golden_train_slomo.npz: two vfi_tpu Super SloMo training steps at the UCF-101 width.

    JAX_PLATFORMS=cpu python tests/make_torch_train_slomo_golden.py

Runs vfi_tpu's SloMoEnvironment at SloMoFillInModel_color (base_dim=32, C=3,
160x192, B=1, K=F=4, T=3, TrainConfig defaults: the perceptual term on) on
the CPU in float32, from the weights, batch, VGG16 weights and projection
vectors of ``chip_smoke.slomo_train_golden_setup()`` (the VGG16 .npz is drawn
into a temporary file from ``vgg_seed``).  Stores the loss terms of steps 1
and 2 and, for every generator parameter, ``<grad, r>`` of the step-1
gradient (``jax.value_and_grad`` of the loss) with its projection vector, so
``chip_smoke.py`` holds the port on the GPU against it without JAX.  Not
collected by pytest.
"""

from __future__ import annotations

import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from vfi_tpu.models.registry import create_model  # noqa: E402
from vfi_tpu.train import environments as jenvs  # noqa: E402
from vfi_tpu.utils.config import TrainConfig  # noqa: E402
from vfi_tpu_torch.utils.params import params_from_jax  # noqa: E402


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    cfg = chip_smoke.SLOMO_TRAIN_GOLDEN
    K, T, F = cfg["K"], cfg["T"], cfg["F"]
    with tempfile.TemporaryDirectory() as tmp:
        port_cfg, g_params, targets, r_g = chip_smoke.slomo_train_golden_setup(os.path.join(tmp, "vgg16.npz"), cfg)
        train_cfg = TrainConfig(K=K, T=T, F=F, vgg16_weights=port_cfg.vgg16_weights)
        assert all(getattr(train_cfg, f) == getattr(port_cfg, f) for f in port_cfg.__dataclass_fields__)
        env = jenvs.create_training_environment(create_model(cfg["model_key"]), train_cfg)
        gp = jax.tree.map(jnp.asarray, g_params)
        state = jenvs.TrainState(step=jnp.zeros((), jnp.int32), g_params=gp, g_opt=env.g_tx().init(gp),
                                 rng=jax.random.PRNGKey(0))
        g_fn = jax.jit(jax.value_and_grad(env._g_loss, has_aux=True), static_argnums=(3, 4, 5))
        _, g_grads = g_fn(gp, state.rng, state.step, K, T, F, targets)
        g_proj = chip_smoke.grad_projections(params_from_jax(g_grads), r_g)
        del g_grads
        terms = []
        for step in range(cfg["steps"]):
            state, m = env.train_step(state, K, T, F, targets)
            terms.append([float(m[n]) for n in chip_smoke.SLOMO_TERM_NAMES])
            print(f"step {step + 1}: " + ", ".join(f"{n}={v:.6g}" for n, v in zip(chip_smoke.SLOMO_TERM_NAMES,
                                                                                  terms[-1])))
    np.savez_compressed(
        chip_smoke.SLOMO_TRAIN_GOLDEN_PATH, **{k: np.asarray(v) for k, v in cfg.items()},
        term_names=np.array(chip_smoke.SLOMO_TERM_NAMES), terms=np.array(terms, np.float64),
        g_keys=np.array(list(r_g)), g_proj=g_proj,
    )
    print(f"wrote {chip_smoke.SLOMO_TRAIN_GOLDEN_PATH} ({os.path.getsize(chip_smoke.SLOMO_TRAIN_GOLDEN_PATH)} bytes)")


if __name__ == "__main__":
    torch.set_num_threads(1)  # the port is only used here to map arrays between layouts
    main()

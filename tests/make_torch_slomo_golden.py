"""Write tests/torch_golden_slomo_color.npz: vfi_tpu's Super SloMo forward at the UCF-101 width.

    JAX_PLATFORMS=cpu python tests/make_torch_slomo_golden.py

Runs vfi_tpu's SloMoFillInModel at SloMoFillInModel_color (base_dim=32, C=3,
256x320, B=2, K=F=4, T=5) on the CPU in float32, in both warp modes
(``"pixel"`` and ``"torch03"``), with the weights of
``random_jax_params("SloMoFillInModel_color", seed=0)`` and the inputs of
``chip_smoke.golden_inputs(SLOMO_GOLDEN)``.  For each mode it keeps every
output's float32 values at 4096 positions and pred's uint8 values at 131072
(``chip_smoke.sampled_golden``), beside the configuration: about 0.3 MB
(random weights make noisy frames, which hardly compress).  ``chip_smoke.py``
holds the port on the GPU against this file, so the card needs no JAX.  Not
collected by pytest.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from vfi_tpu.models.slomo import SloMoFillInModel  # noqa: E402
from vfi_tpu_torch.models.registry import model_config  # noqa: E402
from vfi_tpu_torch.utils.params import random_jax_params  # noqa: E402


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    cfg = chip_smoke.SLOMO_GOLDEN
    params = random_jax_params(cfg["model_key"], cfg["param_seed"])
    p, f = chip_smoke.golden_inputs(cfg)
    arrays = {}
    for mode in chip_smoke.WARP_MODES:
        model = SloMoFillInModel(**model_config(cfg["model_key"])["kwargs"], warp_mode=mode)
        out = jax.jit(lambda prm, p, f: model.apply({"params": prm}, cfg["T"], p, f))(params, p, f)
        arrays.update(chip_smoke.sampled_golden(jax.tree.map(np.asarray, out), cfg, f"{mode}/", chip_smoke.SLOMO_KEYS))
    np.savez_compressed(chip_smoke.SLOMO_GOLDEN_PATH, **arrays, **{k: np.asarray(v) for k, v in cfg.items()})
    print(f"wrote {chip_smoke.SLOMO_GOLDEN_PATH} ({os.path.getsize(chip_smoke.SLOMO_GOLDEN_PATH)} bytes)")


if __name__ == "__main__":
    main()

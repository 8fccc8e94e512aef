"""Write tests/torch_golden_tai_color.npz: the JAX bi-TAI forward at the wide color width.

    JAX_PLATFORMS=cpu python tests/make_torch_color_golden.py

Runs vfi_tpu's TAIFillInModel at the TAI_color configuration (gf=64, ks=51,
num_block=4, C=3, 256x320, B=1, K=F=5, T=3) on the CPU in float32 with
sepconv ``impl="mxu"``, the weights of ``random_jax_params("TAI_color",
seed=0)`` and the inputs of ``chip_smoke.golden_inputs(COLOR_GOLDEN)``.  It
keeps ``pred`` as uint8 frames, and each output (``pred``, ``pred_forward``,
``pred_backward``) as float32 values at the positions
``chip_smoke.golden_points()``, beside the configuration: about 0.6 MB
(random weights make noisy frames, which hardly compress; the two MC-Net
outputs' frames would double that).  ``chip_smoke.py`` holds the port on the GPU
against this file, so the card needs no JAX.  Not collected by pytest.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from vfi_tpu.models.fill_in import TAIFillInModel  # noqa: E402
from vfi_tpu_torch.models.registry import model_config  # noqa: E402
from vfi_tpu_torch.utils.params import random_jax_params  # noqa: E402

OUT = os.path.join(REPO, "tests", "torch_golden_tai_color.npz")


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    cfg = chip_smoke.COLOR_GOLDEN
    model = TAIFillInModel(**model_config(cfg["model_key"])["kwargs"], sepconv_impl="mxu")
    params = random_jax_params(cfg["model_key"], cfg["param_seed"])
    p, f = chip_smoke.golden_inputs(cfg)
    fwd = jax.jit(lambda prm, p, f: model.apply({"params": prm}, cfg["T"], p, f))
    out = fwd(params, p, f)
    points = chip_smoke.golden_points(cfg)
    arrays = {"points": points, "pred_u8": chip_smoke.u8(np.asarray(out["pred"], np.float32))}
    for k in chip_smoke.PRED_KEYS:
        arrays[f"{k}_at_points"] = np.asarray(out[k], np.float32).reshape(-1)[points]
    np.savez_compressed(OUT, **arrays, **{k: np.asarray(v) for k, v in cfg.items()})
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()

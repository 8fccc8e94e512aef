"""Write tests/torch_golden_tai_gray_int8.npz: vfi_tpu's int8 bi-TAI forwards at full width.

    JAX_PLATFORMS=cpu python tests/make_torch_int8_golden.py

Runs vfi_tpu's TAIFillInModel at the TAI_gray configuration (gf=64, ks=51,
num_block=5, gray 128x128, B=1, K=F=T=5) on the CPU in float32, with the
weights of ``random_jax_params("TAI_gray", seed=0)`` and the inputs of
``chip_smoke.golden_inputs()`` (``chip_smoke.GOLDEN``), in vfi_tpu's two int8
modes:

  * static (``VFI_INT8=2``): the "quant" collection calibrated on those inputs
    from zero (flax creates each ``act_amax`` at 0.0 in a mutable apply),
    then the forward with it: ``pred_static``, and every ``act_amax`` under
    ``amax/<flax path>``;
  * dynamic (``VFI_INT8=1``): ``pred_dynamic``.

``chip_smoke.py`` holds the port on the GPU against this file.  Not
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
from vfi_tpu.models.registry import create_model  # noqa: E402
from vfi_tpu_torch.utils.params import random_jax_params  # noqa: E402

OUT = os.path.join(REPO, "tests", "torch_golden_tai_gray_int8.npz")


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    cfg = chip_smoke.GOLDEN
    T = cfg["T"]
    params = random_jax_params(cfg["model_key"], cfg["param_seed"])
    p, f = chip_smoke.golden_inputs(cfg)
    os.environ["VFI_INT8"] = "2"  # read while the model traces
    model = create_model(cfg["model_key"])
    quant = jax.jit(lambda prm: model.apply({"params": prm}, T, p, f, mutable=["quant"])[1]["quant"])(params)
    static = jax.jit(lambda prm, q: model.apply({"params": prm, "quant": q}, T, p, f)["pred"])(params, quant)
    os.environ["VFI_INT8"] = "1"
    dynamic = jax.jit(lambda prm: model.apply({"params": prm}, T, p, f)["pred"])(params)
    os.environ.pop("VFI_INT8")
    amax = {"amax/" + "/".join(path[:-1]): a for path, a in _flat(jax.device_get(quant))}
    np.savez_compressed(OUT, pred_static=np.asarray(static, np.float32), pred_dynamic=np.asarray(dynamic, np.float32),
                        **amax, **{k: np.asarray(v) for k, v in cfg.items()})
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes, {len(amax)} act_amax)")


if __name__ == "__main__":
    main()

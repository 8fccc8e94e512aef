"""Write tests/torch_golden_sct_gray.npz: vfi_tpu's deterministic SCT variants at the KTH width.

    JAX_PLATFORMS=cpu python tests/make_torch_sct_golden.py

Runs vfi_tpu's SCT Forward, Inward, Bypass and FrameEncDecBN at their
``_gray`` registry widths (num_blocks=2, num_heads=3, d_v=256; gray 128x128,
B=1, K=T=F=5) on the CPU in float32, and Forward's teacher-forced pass
(``forward_train`` on the true middle frames), each with the weights of
``random_jax_params(key, seed=0)`` and the inputs of
``chip_smoke.sct_golden_inputs()`` (``chip_smoke.SCT_GOLDEN_RUNS``).  For each
run it keeps pred's float32 values at 4096 positions and all of pred as
uint8 (``chip_smoke.sampled_golden``), beside the configuration: about 0.3
MB.  ``chip_smoke.py`` holds the port on the GPU against this file.  Not
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


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    cfg = chip_smoke.SCT_GOLDEN
    p, m, f = chip_smoke.sct_golden_inputs(cfg)
    arrays = {}
    for run, key in chip_smoke.SCT_GOLDEN_RUNS.items():
        model = create_model(key)
        params = random_jax_params(key, cfg["param_seed"])
        if run == "forward_train":
            fwd = jax.jit(lambda prm, p, m, f: model.apply({"params": prm}, cfg["T"], p, f, m, method="forward_train"))
            out = fwd(params, p, m, f)
        else:
            out = jax.jit(lambda prm, p, f: model.apply({"params": prm}, cfg["T"], p, f))(params, p, f)
        arrays.update(chip_smoke.sampled_golden({"pred": np.asarray(out["pred"])}, cfg, f"{run}/", ("pred",)))
        print(run, "mean |pred|", float(np.abs(np.asarray(out["pred"])).mean()))
    np.savez_compressed(chip_smoke.SCT_GOLDEN_PATH, **arrays, **{k: np.asarray(v) for k, v in cfg.items()})
    print(f"wrote {chip_smoke.SCT_GOLDEN_PATH} ({os.path.getsize(chip_smoke.SCT_GOLDEN_PATH)} bytes)")


if __name__ == "__main__":
    main()

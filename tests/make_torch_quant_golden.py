"""Write tests/torch_golden_quant_toy.npz: vfi_tpu's side of tests/test_torch_quant.py.

    JAX_PLATFORMS=cpu python tests/make_torch_quant_golden.py

On the inputs that test module makes (its constants, ``_tai_inputs``,
``random_jax_params`` seeds and its ``cli_root`` recipe), on the CPU:

  * the toy TAI (``TAI``, weights of seed 0) under ``VFI_INT8=2``: the
    "quant" collection calibrated from zero (flax creates each ``act_amax``
    at 0.0 in a mutable apply), as ``amax/<flax path>``, and the static
    forward with it, ``static/<key>``; under ``VFI_INT8=1`` the dynamic
    forward, ``dynamic/<key>``, and the lhs shapes of its int8 convs in
    program order, ``calls``;
  * vfi_tpu's ``cli/predict.py`` in this process with ``--quantize
    int8_dynamic --validate_quant 0 --device_normalize`` on the vfi_tpu
    snapshot and clips of ``cli_root``: every ``pred_middle_*.png`` as
    ``png/<clip>/<name>``.

The test module reads these instead of running vfi_tpu each time.
Regenerate only if vfi_tpu, ``random_jax_params`` or the test's inputs
change.  Not collected by pytest.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from tests import test_torch_quant as tq  # noqa: E402
from vfi_tpu.models.registry import create_model  # noqa: E402
from vfi_tpu_torch.utils.params import random_jax_params  # noqa: E402

OUT = os.path.join(REPO, "tests", "torch_golden_quant_toy.npz")


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def tai_side() -> dict:
    params = random_jax_params(tq.TAI, 0)
    p, f = tq._tai_inputs()
    model = create_model(json.dumps(tq.TAI))
    T = 3
    os.environ["VFI_INT8"] = "2"
    calib = jax.jit(lambda prm: model.apply({"params": prm}, T, p, f, mutable=["quant"])[1]["quant"])(params)
    static = jax.jit(lambda prm, q: model.apply({"params": prm, "quant": q}, T, p, f))(params, calib)
    os.environ["VFI_INT8"] = "1"
    traced = jax.jit(lambda prm: model.apply({"params": prm}, T, p, f)).trace(params)
    calls = tq._int8_conv_inputs(traced.jaxpr.jaxpr)
    dynamic = traced.lower().compile()(params)
    del os.environ["VFI_INT8"]
    out = {f"amax/{k}": v for k, v in _flat(jax.device_get(calib))}
    out.update({f"static/{k}": np.asarray(static[k]) for k in tq.PRED_KEYS})
    out.update({f"dynamic/{k}": np.asarray(dynamic[k]) for k in tq.PRED_KEYS})
    out["calls"] = np.asarray(calls, np.int64)
    return out


def cli_side() -> dict:
    with tempfile.TemporaryDirectory(prefix="quant_golden_") as tmp:
        root = tq.make_cli_root(tmp)
        qual = os.path.join(root, "qual_jax")
        spec = importlib.util.spec_from_file_location("vfi_tpu_predict_cli", os.path.join(REPO, "cli", "predict.py"))
        jax_predict = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(jax_predict)
        os.environ["VFI_INT8"] = "0"
        jax_predict.main(tq._args(root, qual, "ckpt_jax", *tq.CLI_DYNAMIC))
        del os.environ["VFI_INT8"]
        return {f"png/{clip}/{name}": png for (clip, name), png in tq._pred_pngs(qual).items()}


def main() -> None:
    out = {**tai_side(), **cli_side(), "tai_param_seed": np.asarray(0), "cli": np.asarray(json.dumps(tq.CLI_META))}
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {len(out)} arrays")


if __name__ == "__main__":
    main()

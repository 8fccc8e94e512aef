"""Write tests/torch_golden_train_cli.npz: vfi_tpu's side of tests/test_torch_train_cli.py.

    JAX_PLATFORMS=cpu python tests/make_torch_train_cli_golden.py

On the inputs that test module makes (its constants, clip lists, start
snapshot and ``plan``), on the CPU with one torch thread (as in every
pytest-xdist worker, tests/torch_threads.py):

  * the port's first invocation (iterations 1-2), and the fingerprint
    (``tests/test_torch_train_cli.fingerprint``) of its iteration-2 snapshot
    converted back by to_jax: ``port_at_2/<path>``;
  * vfi_tpu's cli/train.py in this process with tensorboardX unimportable:
    the first invocation, then, with its model_latest.ckpt replaced by
    ``port_at_2``, the resume to 5 under --sample_KTF: its JSON log,
    ``jax_log``, and its model_00000004.ckpt, ``jax_iter4/<path>`` and
    ``jax_iter4_counters/<name>``.

The test module reads these instead of running vfi_tpu (two invocations,
about 40 s of init) each time.  Regenerate only if vfi_tpu, the port's
training, or the test's inputs change; the test fails on a golden whose
``port_at_2`` is not the port's iteration-2 snapshot.  Not collected by
pytest.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from scripts.convert_checkpoint_torch import read_jax_snapshot  # noqa: E402
from tests import test_torch_train_cli as tc  # noqa: E402
from vfi_tpu.utils import checkpoint as jckpt  # noqa: E402

OUT = os.path.join(REPO, "tests", "torch_golden_train_cli.npz")


def _flat(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def main() -> None:
    with tempfile.TemporaryDirectory(prefix="train_cli_golden_") as root:
        lists = tc._lists(root, tc.LENS, "clips")
        tc._start_snapshot(root, "run")
        tc.run_port(root, lists, 0)
        port_at_2, counters_2 = tc.port_state(root, "model_latest.ckpt")
        jckpt.save_snapshot(os.path.join(root, "port_at_2"), "model_latest.ckpt", port_at_2, counters_2)

        sys.modules["tensorboardX"] = None  # vfi_tpu's make_writer then returns None
        spec = importlib.util.spec_from_file_location("vfi_tpu_train_cli", os.path.join(REPO, "cli", "train.py"))
        cli = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cli)
        first, second = (tc._args(root, "jax", *p) for p in tc.plan(lists))
        cli.main(first)
        latest = os.path.join(root, "ckpt_jax", "run", "model_latest.ckpt")
        shutil.rmtree(latest)
        shutil.copytree(os.path.join(root, "port_at_2", "model_latest.ckpt"), latest)
        cli.main(second)

        state, counters = read_jax_snapshot(os.path.join(root, "ckpt_jax", "run", "model_00000004.ckpt"))
        with open(os.path.join(root, "jax_run.jsonl")) as f:
            log = f.read()
    out = {"/".join(("port_at_2",) + k): v for k, v in tc.fingerprint(port_at_2).items()}
    out.update(_flat(state, "jax_iter4"))
    out.update(_flat(counters, "jax_iter4_counters"))
    out["jax_log"] = np.asarray(log)
    out["meta"] = np.asarray(json.dumps(tc.GOLDEN_META))
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {len(out)} arrays, {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()

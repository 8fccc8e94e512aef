"""Convert a reference (PyTorch) checkpoint into a port snapshot (counterpart
of vfi_tpu's ``cli/import_torch_checkpoint.py``).

    python -m vfi_tpu_torch.cli.import_torch_checkpoint CKPT --model_key TAI_gray \\
        --dest_dir checkpoints/kth_tai_imported [--snapshot_file_name model_best.ckpt]

The upstream project distributes pretrained snapshots saved as torch pickles
(Python 2, PyTorch 0.3): ``{'updates', 'sum_avg_psnr_err',
'sum_avg_ssim_err', 'generator': state_dict, 'optimizer_G': ...}``
(src/environments/environments.py:178-194).  This tool maps the generator
weights onto the port's model (``utils/torch_import.py``) and writes a
snapshot ``DEST_DIR/SNAPSHOT_FILE_NAME`` (``utils/checkpoint.py``) that
``cli.predict`` serves with ``--checkpoints_dir`` and ``--name`` naming
DEST_DIR, and ``api.VideoInpainter.from_checkpoint`` loads.  A checkpoint
with a ``discriminator`` carries it over, ``u`` buffers included.  No
optimizer state is written (Adam moments are not carried over), so the
snapshot serves and is not a training state to resume.

Accepts either a full snapshot dict or a bare generator state_dict (.pth).
The imported state_dict must equal the model's, key for key and shape for
shape (the model is built on the meta device, so vfi_tpu's ``--image_size``
for its shape check has no counterpart).  Runs on the host; no device is
used.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..models.registry import create_model, model_config
from ..utils import checkpoint as ckpt
from ..utils.torch_import import import_discriminator_state_dict, import_generator_state_dict, model_kind_for_key


def load_torch_pickle(path: str):
    """Load a torch checkpoint saved by the (Python 2) reference."""
    return torch.load(path, map_location="cpu", weights_only=False, encoding="latin1")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("checkpoint", help="path to the reference .ckpt / .pth file")
    ap.add_argument("--model_key", required=True, help="registry key (e.g. TAI_gray) or JSON literal")
    ap.add_argument("--dest_dir", required=True, help="directory to write the snapshot into")
    ap.add_argument("--snapshot_file_name", default="model_best.ckpt")
    ap.add_argument("--df_dim", type=int, default=64,
                    help="discriminator feature width (needed to unflatten the "
                         "SN linear head when the checkpoint has a discriminator)")
    args = ap.parse_args(argv)

    payload = load_torch_pickle(args.checkpoint)
    if "generator" in payload:
        sd = payload["generator"]
        counters = {
            "updates": int(payload.get("updates", 0)),
            "sum_avg_psnr_err": float(payload.get("sum_avg_psnr_err", 0.0)),
            "sum_avg_ssim_err": float(payload.get("sum_avg_ssim_err", 0.0)),
        }
    else:  # bare state_dict
        sd = payload
        counters = {"updates": 0, "sum_avg_psnr_err": 0.0, "sum_avg_ssim_err": 0.0}
    sd = {k: np.asarray(v) for k, v in sd.items()}

    cfg = model_config(args.model_key)
    json_key = args.model_key.strip().startswith("{") or args.model_key.endswith(".json")
    key = cfg["class"] if json_key else args.model_key
    kwargs = cfg.get("kwargs", {})
    state, report = import_generator_state_dict(sd, model_kind_for_key(key), num_block=kwargs.get("num_block", 5),
                                                layers=kwargs.get("layers", 3))
    print(f"import: {report}")

    # Structural gate: the imported state_dict must be the model's, key for key and shape for shape.
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in create_model(args.model_key).state_dict().items()}
    if sorted(want) != sorted(state):
        raise SystemExit(f"state_dict mismatch: missing={sorted(set(want) - set(state))} "
                         f"extra={sorted(set(state) - set(want))}")
    for k, shape in want.items():
        if tuple(state[k].shape) != shape:
            raise SystemExit(f"shape mismatch at {k}: got {tuple(state[k].shape)}, model wants {shape}")

    out = {"generator": state, "step": counters["updates"], "counters": counters}
    d_report = None
    if "discriminator" in payload:
        dsd = {k: np.asarray(v) for k, v in payload["discriminator"].items()}
        out["discriminator"], d_report = import_discriminator_state_dict(dsd, args.df_dim)
        print(f"discriminator import: {d_report}")
    ckpt.write_payload(args.dest_dir, args.snapshot_file_name, out)
    path = os.path.join(args.dest_dir, args.snapshot_file_name)
    n_params = sum(int(np.prod(s)) for s in want.values())
    print(f"wrote {path} ({n_params} params, updates={counters['updates']})")
    return {"report": report, "discriminator_report": d_report, "snapshot": path, "params": n_params}


if __name__ == "__main__":
    main()

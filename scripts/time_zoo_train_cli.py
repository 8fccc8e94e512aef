#!/usr/bin/env python3
"""Where the train CLI's iteration time goes for Super SloMo, on one GPU.

    python3 scripts/time_zoo_train_cli.py

Runs ``vfi_tpu_torch.cli.train`` with SloMoFillInModel_color at UCF-101's
training lengths and crop (K=4, T=3, F=4, 160x192, B=8, bf16,
``--device_normalize``, the perceptual term on a seeded VGG16 ``.npz``) on
32 synthetic clips, 40 iterations at fixed lengths in six modes: with the
TensorBoard writer at ``--print_freq`` 1 (as ``chip_smoke.py``'s
``slomo_train_cli`` runs), the same with the writer's record CRC stubbed out
(TensorBoard computes crc32c in pure Python in its writer thread, which
holds the GIL), with the writer at 10, without a writer at both, and
without a writer from 8 batches cached on the card.  One JSON line per mode: ms/it
(the median of the print windows after the first), the windows, the
host's milliseconds per iteration (waiting for the prefetcher, copying and
normalising, dispatching the step, the sync at each print) and the seconds
of the ``train_vis`` grids (outside ms/it).  Needs a GPU.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

# (mode, extra flags, without a writer, with TensorBoard's record CRC stubbed out)
MODES = (("writer_print_freq_1", ("--print_freq", "1"), False, False),
         ("writer_print_freq_1_crc_stubbed", ("--print_freq", "1"), False, True),
         ("writer_print_freq_10", ("--print_freq", "10"), False, False),
         ("no_writer_print_freq_1", ("--print_freq", "1"), True, False),
         ("no_writer_print_freq_10", ("--print_freq", "10"), True, False),
         ("no_writer_print_freq_10_device_cache_8", ("--print_freq", "10", "--device_cache", "8"), True, False))


@contextlib.contextmanager
def crc_stubbed():
    """TensorBoard's record writer with a zero CRC in place of its pure-Python
    crc32c (the events are then unreadable: for timing only)."""
    from tensorboard.summary.writer import record_writer

    real = record_writer.masked_crc32c
    record_writer.masked_crc32c = lambda data: 0
    try:
        yield
    finally:
        record_writer.masked_crc32c = real


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_zoo_train_cli: this script needs a GPU")
    c = cs.SLOMO_TRAIN
    root = tempfile.mkdtemp(prefix="zoo_train_cli_")
    try:
        vgg = cs.random_vgg16_npz(os.path.join(root, "vgg16.npz"), c["vgg_seed"])
        lists = {flag: cs.make_videolist(os.path.join(root, name), n, c["clip_seed"] + i,
                                         n_frames=c["K"] + c["T"] + c["F"], hw=c["H"], width=c["W"])
                 for i, (flag, name, n) in enumerate((("--train_video_list_path", "train", c["train_clips"]),
                                                      ("--val_video_list_path", "val", c["val_clips"])))}
        base = [*cs.UCF_FIXED_ARGS, *(a for kv in lists.items() for a in kv), "--batch_size", str(c["batch"]),
                "--checkpoints_dir", os.path.join(root, "ckpt"), "--tensorboard_dir", os.path.join(root, "tb"),
                "--vgg16_weights", vgg, "--train_dtype", "bfloat16", "--device_normalize", "--save_latest_freq",
                "1000", "--validate_freq", "1000", "--max_iter", "40"]
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
        for mode, extra, blind, no_crc in MODES:
            log = os.path.join(root, f"{mode}.jsonl")
            with cs.no_tensorboard() if blind else crc_stubbed() if no_crc else contextlib.nullcontext():
                stats, _ = cs.run_train([*base, *extra, "--name", mode, "--log_json", log])
            windows = [e["ms_per_it"] for e in cs._events(root, mode, "iter")]
            n = stats["iters"]
            print(json.dumps({"mode": mode, "model": c["model_key"], "batch": c["batch"], "dtype": "bfloat16",
                              "ms_per_it": float(np.median(windows[1:])), "windows": windows,
                              "host_ms_per_it": {k: stats[k] / n * 1e3 for k in ("wait_data_s", "prep_s", "step_s",
                                                                                 "sync_s")},
                              "train_vis_s": stats["vis_s"], "tensorboard": stats["tensorboard"], "card": smi}),
                  flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()

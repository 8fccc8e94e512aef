"""A copy of the benchmark's cells at a size a CPU test run holds: the same
files, with the models' widths, the frames and the traffic cut down."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.bench import PKG, REPO

# Limits of the tiny cells, between the sound readings and the controls'
# at this size (test_portbench_faults.py reads both).
LIMITS = {"serve": {"rms_vs_bf16": 2.5}, "serve_int8": {"rms_vs_bf16": 30.0},
          "train": {"loss_rel_first": 0.008, "grad_vs_bf16_G": 2.5, "grad_vs_bf16_D": 2.5, "update_gap_G": 0.008,
                    "update_gap_D": 0.006}}


def make(root: Path) -> Path:
    """Write the tiny benchmark under ``root``; returns ``root``."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for sub in ("configs", "traffic", "limits"):
        (root / "portbench" / sub).mkdir(parents=True, exist_ok=True)
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg["model_kwargs"].update(gf_dim=8, ks=5)
        cfg["image_size"] = [32, 32]
        cfg["train"]["df_dim"] = 8
        (root / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        tr = json.loads((PKG / "traffic" / f"{w['traffic']}.json").read_text())
        if tr["entry"] == "serve":
            tr.update(batch=2, distinct=2, warmup=1, check_requests=2, trace_seconds=1)
            limits = LIMITS["serve_int8" if tr["quantize"] != "none" else "serve"]
        else:
            tr.update(batch=2, K=[2, 3], T=[1, 2], F=[2, 3], trace_steps=3, print_freq=4)
            limits = LIMITS["train"]
        (root / "portbench" / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(tr))
        (root / "portbench" / "limits" / f"{w['name']}.json").write_text(json.dumps(limits))
    shutil.copytree(PKG / "metrics", root / "portbench" / "metrics", dirs_exist_ok=True)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root

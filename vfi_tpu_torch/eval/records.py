"""Experiment registry + legacy paper-figure generators (counterpart of
``vfi_tpu/eval/records.py``).

Modernized equivalent of the reference's records/finished_exp.npy-keyed
tooling (src/util/plots.py:113-121, src/util/images.py:218-242): the registry
is a JSON file mapping dataset -> model -> "<K>_<K+T>" -> [experiment names],
and the generators produce metric-vs-timestep plots (matplotlib, imported
when a plot is drawn) and sliding image strips (PIL) for registered
experiments.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..utils.optional import require


class ExperimentRegistry:
    """JSON-backed registry: registry[dataset][model][io_key] -> [exp names]."""

    def __init__(self, path: str = "records/experiments.json"):
        self.path = path
        self.data: Dict = {}
        if os.path.isfile(path):
            with open(path) as f:
                self.data = json.load(f)

    def register(self, dataset: str, model: str, io_key: str, exp_name: str) -> None:
        bucket = self.data.setdefault(dataset, {}).setdefault(model, {}).setdefault(io_key, [])
        if exp_name not in bucket:
            bucket.append(exp_name)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(self.data, f, indent=2, sort_keys=True)

    def latest(self, dataset: str, model: str, io_key: str) -> Optional[str]:
        try:
            return self.data[dataset][model][io_key][-1]
        except (KeyError, IndexError):
            return None


def metric_plot_for_models(
    registry: ExperimentRegistry,
    results_dir: str,
    dataset: str,
    models: List[str],
    io_key: str,
    metric: str,
    out_path: str,
) -> None:
    """Per-timestep metric curves for every registered model on one dataset."""
    matplotlib = require("matplotlib", "metric_plot_for_models")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    for model in models:
        exp = registry.latest(dataset, model, io_key)
        if exp is None:
            print(f"exp with {{{dataset}, {model}, {io_key}}} does not exist")
            continue
        npz = os.path.join(results_dir, "quantitative", dataset, exp, "results.npz")
        table = np.load(npz)[metric]
        if metric == "psnr":
            table = np.minimum(table, 100)
        avg = table.mean(axis=0)
        ax.plot(np.arange(1, len(avg) + 1), avg, marker="d", label=model)
    ax.set_xlabel("time steps")
    ax.set_ylabel(metric.upper())
    ax.grid(True)
    ax.legend()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight")


def image_strip(
    clip_dirs: List[str], labels: List[str], out_path: str, skip: int = 1, start: int = 0
) -> None:
    """Horizontal frame strips, one row per experiment (images.py equivalent)."""
    from PIL import Image

    from .animate import files_matching

    rows = []
    for d in clip_dirs:
        names = (
            files_matching(d, r"gt_preceding_[0-9]+\.png")
            + files_matching(d, r"pred_middle_[0-9]+\.png")
            + files_matching(d, r"gt_following_[0-9]+\.png")
        )
        frames = [np.asarray(Image.open(p).convert("RGB")) for p in names[start::skip]]
        rows.append(np.concatenate(frames, axis=1))
    width = max(r.shape[1] for r in rows)
    rows = [np.pad(r, ((0, 0), (0, width - r.shape[1]), (0, 0))) for r in rows]
    strip = np.concatenate(rows, axis=0)
    Image.fromarray(strip).save(out_path)

"""Quantitative evaluation: PNG prediction dirs -> results.npz -> summaries
(counterpart of ``vfi_tpu/eval/quant.py``).

Behavioral reference: compute_quant_results.py (per-clip PSNR/SSIM vs GT into
``results.npz {psnr: N x T, ssim: N x T, video: N}``) and
summarize_quant_results.py (plots/tables; PSNR clamped at 100).  The file
format is vfi_tpu's, so vfi_tpu's ``cli/summarize_quant_results.py`` reads
the port's output unchanged.

Frames for a batch of clips are stacked and scored at once on a torch device
(``ops/metrics.py``) instead of the reference's per-frame skimage loop.  PNGs
are read by the port's own codec (``utils/png.py``).
"""

from __future__ import annotations

import os
from collections import deque
from typing import List

import numpy as np
import torch

from ..api import resolve_device
from ..ops.metrics import psnr as psnr_fn, ssim as ssim_fn
from ..utils.png import read_png


def get_folder_paths_at_depth(root_path: str, depth: int) -> List[str]:
    """BFS for folders exactly `depth` levels below root (util.py:212-232)."""
    assert depth >= 0
    q = deque([(root_path, 0)])
    out = []
    while q:
        path, d = q.popleft()
        if os.path.isdir(path):
            if d == depth:
                out.append(path)
            else:
                for child in sorted(os.listdir(path)):
                    q.append((os.path.join(path, child), d + 1))
    return out


def _load_frame(path: str) -> np.ndarray:
    img = read_png(path)
    if img.ndim == 2:
        img = img[..., None]
    return img


def compute_quant_results(
    qual_results_root: str, quant_results_root: str, K: int, T: int, depth: int = 1, batch: int = 64, device=None
) -> dict:
    """Walk predict output folders and write results.npz; the metrics run on
    ``device`` (``cuda`` unless ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    roots = get_folder_paths_at_depth(qual_results_root, depth)
    if not roots:
        raise RuntimeError(
            "Failed to find any qualitative results (run the predict CLI first)"
        )

    psnr_rows, ssim_rows = [], []
    for start in range(0, len(roots), batch):
        chunk = roots[start : start + batch]
        gts, preds = [], []
        for root in chunk:
            for t in range(K, K + T):
                gt_p = os.path.join(root, f"gt_middle_{t:04d}.png")
                if not os.path.isfile(gt_p):
                    raise RuntimeError(f"missing GT middle frame {gt_p}")
                gts.append(_load_frame(gt_p))
                preds.append(_load_frame(os.path.join(root, f"pred_middle_{t:04d}.png")))
        gt_b = torch.from_numpy(np.stack(gts)).to(dev, torch.float32)
        pr_b = torch.from_numpy(np.stack(preds)).to(dev, torch.float32)
        p = psnr_fn(pr_b, gt_b).cpu().numpy().reshape(len(chunk), T)
        s = ssim_fn(pr_b, gt_b).cpu().numpy().reshape(len(chunk), T)
        psnr_rows.append(p)
        ssim_rows.append(s)

    result = {
        "psnr": np.concatenate(psnr_rows),
        "ssim": np.concatenate(ssim_rows),
        "video": np.array(roots),
    }
    os.makedirs(quant_results_root, exist_ok=True)
    np.savez(os.path.join(quant_results_root, "results.npz"), **result)
    return result


def load_all_tables(quant_results_roots: List[str]) -> dict:
    """Load results.npz tables; clamp PSNR at 100 (summarize:289)."""
    tables = {"psnr": {}, "ssim": {}, "videos": {}}
    for root in quant_results_roots:
        data = np.load(os.path.join(root, "results.npz"))
        p = data["psnr"].copy()
        p[p > 100] = 100
        tables["psnr"][root] = p
        tables["ssim"][root] = data["ssim"]
        tables["videos"][root] = data["video"]
    return tables


def video_scores(video_list, metric_table, summary_method: str = "mean"):
    """Sorted (video, score) pairs; score = per-video mean (or min) over frames."""
    reduce = {"mean": np.mean, "min": np.min}[summary_method]
    scores = [(v, float(reduce(metric_table[i]))) for i, v in enumerate(video_list)]
    return sorted(scores, key=lambda kv: kv[1])


def metric_summary_rows(tables, roots_and_labels, metric, mean_precision=2, std_err_precision=3):
    """Rows of the paper tables: per-video mean-over-frames, then mean +- stderr
    (summarize_quant_results.py:224-232)."""
    rows = []
    for root, label in roots_and_labels:
        per_video = tables[metric][root].mean(axis=1)
        mean = per_video.mean()
        std_err = per_video.std() / np.sqrt(per_video.size)
        rows.append([label, f"%.{mean_precision}f" % mean, f"%.{std_err_precision}f" % std_err])
    return rows

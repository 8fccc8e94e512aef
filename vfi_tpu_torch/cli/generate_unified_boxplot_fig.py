"""Per-video boxplot paper figure: 4 horizontal-boxplot panels
(PSNR at T_a, PSNR at T_b, SSIM at T_a, SSIM at T_b), one box per model,
first model on top (counterpart of vfi_tpu's
``cli/generate_unified_boxplot_fig.py``; reference
generate_unified_boxplot_fig.py:22-159).

    python -m vfi_tpu_torch.cli.generate_unified_boxplot_fig --results_root R --dest_path fig.pdf \\
        --dataset KTH --T_a 5 --T_b 10 --exp_names A B --model_labels A B \\
        --psnr_range 20 40 --ssim_range .6 1

Reads ``R/<dataset>-test_data_list_T=<T>/quantitative/<exp>/results.npz``;
needs matplotlib, and raises an ``ImportError`` naming it where it is missing.
"""

import argparse
import os

import numpy as np

from ..eval.figures import cm2in
from ..utils.optional import require


def _draw_panel(ax, tables, labels, hide_labels=False):
    """Horizontal per-video-mean boxplot, first model on top (ref :22-52)."""
    scores = [np.minimum(t, 100).mean(axis=1) for t in tables]
    items = ax.boxplot(scores[::-1], vert=False, patch_artist=True,
                       flierprops=dict(markersize=1), medianprops=dict(color="black"))
    for patch in items["boxes"]:
        patch.set_facecolor("lightblue")
    if hide_labels:
        ax.set_yticklabels([""] * len(labels))
    else:
        ax.set_yticklabels(labels[::-1])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--results_root", type=str, default="results")
    p.add_argument("--dest_path", type=str, required=True)
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--T_a", type=int, required=True)
    p.add_argument("--T_b", type=int, required=True)
    p.add_argument("--exp_names", type=str, nargs="+", required=True)
    p.add_argument("--model_labels", type=str, nargs="+", required=True)
    p.add_argument("--psnr_range", type=float, nargs=2, required=True)
    p.add_argument("--ssim_range", type=float, nargs=2, required=True)
    args = p.parse_args(argv)
    if len(args.exp_names) != len(args.model_labels):
        raise ValueError("Number of arguments to --exp_names and --model_labels must match")

    matplotlib = require("matplotlib", "generate_unified_boxplot_fig")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.rcParams["font.family"] = "serif"
    plt.rcParams["font.size"] = 7

    template = os.path.join(args.results_root, "{dataset}-test_data_list_T={T}",
                            "quantitative", "{exp}", "results.npz")

    def load(T, metric):
        out = []
        for exp in args.exp_names:
            path = template.format(dataset=args.dataset, T=T, exp=exp)
            try:
                out.append(np.load(path)[metric])
            except IOError:
                raise ValueError(f"Failed to read file {path}")
        return out

    fig = plt.figure(figsize=(cm2in(18.2), cm2in(4)))
    panels = [
        (f"Mean PSNR (m={args.T_a})", load(args.T_a, "psnr"), args.psnr_range, False),
        (f"Mean PSNR (m={args.T_b})", load(args.T_b, "psnr"), args.psnr_range, True),
        (f"Mean SSIM (m={args.T_a})", load(args.T_a, "ssim"), args.ssim_range, True),
        (f"Mean SSIM (m={args.T_b})", load(args.T_b, "ssim"), args.ssim_range, True),
    ]
    for i, (xlabel, tables, rng, hide) in enumerate(panels):
        ax = fig.add_subplot(111, label=chr(ord("a") + i))
        ax.set_position([0.12 + 0.22 * i, 0.25, 0.2, 0.68])
        ax.set_xlabel(xlabel)
        ax.set_xlim(rng[0], rng[1])
        ax.tick_params(axis="y", left=False)
        _draw_panel(ax, tables, args.model_labels, hide_labels=hide)

    d = os.path.dirname(args.dest_path)
    if d:
        os.makedirs(d, exist_ok=True)
    fig.savefig(args.dest_path)
    print(f"wrote {args.dest_path}")


if __name__ == "__main__":
    main()

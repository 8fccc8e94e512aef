"""Summaries, plots and tables over results.npz files (counterpart of
vfi_tpu's ``cli/summarize_quant_results.py``).

    python -m vfi_tpu_torch.cli.summarize_quant_results metric_summary_text_file \\
        --quant_results_roots QUANT_A QUANT_B --labels A B --dest_path tables --metric psnr

Five subcommands, as in the reference's summarize_quant_results.py:
``avg_metric_plot``, ``video_metric_text_file``, ``sorted_metric_plot``,
``metric_box_plot`` and ``metric_summary_text_file`` (the one that
regenerates quant_tables_orig/*.txt, byte for byte).  The two text
subcommands need only numpy; the three plot subcommands import matplotlib
when they run, and raise an ``ImportError`` naming it where it is missing.
Runs on the host.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..eval.quant import load_all_tables, metric_summary_rows, video_scores
from ..eval.tables import render_table

COMMON = dict(
    quant_results_roots=dict(type=str, nargs="+", required=True),
    labels=dict(type=str, nargs="+", default=None),
    dest_path=dict(type=str, required=True),
    metric=dict(type=str, default="psnr", choices=["psnr", "ssim"]),
    summary_method=dict(type=str, default="mean", choices=["mean", "min"]),
    T=dict(type=int, default=None),
    range=dict(type=float, nargs="+", default=None),
    fig_size=dict(type=float, nargs="+", default=None),
    title=dict(type=str, default=None),
    mean_precision=dict(type=int, default=2),
    std_err_precision=dict(type=int, default=3),
)


def _add(sub, *keys):
    for k in keys:
        sub.add_argument(f"--{k}", **COMMON[k])


def _pyplot():
    """matplotlib's pyplot on the Agg backend, in the paper's serif font."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the plot subcommands need matplotlib, which is not installed; "
                          "video_metric_text_file and metric_summary_text_file run without it",
                          name="matplotlib") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.rcParams["font.family"] = "serif"
    return plt


def avg_metric_plot(args, tables, pairs):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(2.2, 2.5) if args.fig_size is None else args.fig_size)
    T = args.T or next(iter(tables[args.metric].values())).shape[1]
    for root, label in pairs:
        table = tables[args.metric][root]
        avg = table.mean(axis=0)
        stderr = table.std(axis=0) / np.sqrt(table.shape[0])
        x = np.arange(1, len(avg) + 1)
        ax.plot(x, avg, marker="d", markersize=2, linewidth=0.7, label=label)
        # two standard errors ~ 95% of variation (ref summarize :40-47)
        ax.fill_between(x, avg - 2 * stderr, avg + 2 * stderr, alpha=0.2)
    ax.set_xlabel("time steps")
    ax.set_ylabel(args.metric.upper())
    if args.range is not None:
        ax.axis([1, T, args.range[0], args.range[1]])
    if args.title:
        ax.set_title(args.title)
    ax.grid(True, linewidth=0.2)
    if any(l for _, l in pairs):
        ax.legend(ncol=2, loc="upper center", bbox_to_anchor=(0.31, -0.33), fontsize=5)
    fig.savefig(os.path.join(args.dest_path, f"{args.metric}_final.pdf"), bbox_inches="tight")
    fig.savefig(os.path.join(args.dest_path, f"{args.metric}_final.png"), bbox_inches="tight")


def video_metric_text_file(args, tables, pairs):
    out_path = os.path.join(args.dest_path, f"sorted_{args.metric}_scores.txt")
    with open(out_path, "w") as f:
        for root, label in pairs:
            scores = video_scores(tables["videos"][root], tables[args.metric][root], args.summary_method)
            if label is not None:
                f.write(f"{label}:\n")
            for v, s in scores:
                f.write(f"{v}, {s}\n")
            f.write("\n")


def sorted_metric_plot(args, tables, pairs):
    plt = _pyplot()
    fig, ax = plt.subplots()
    for root, label in pairs:
        scores = [s for _, s in video_scores(tables["videos"][root], tables[args.metric][root], args.summary_method)]
        ax.plot(scores, label=label)
    ax.set_xlabel("Video rank")
    ax.set_ylabel(f"{args.metric.upper()} score ({args.summary_method})")
    if args.title:
        ax.set_title(args.title)
    if any(l for _, l in pairs):
        ax.legend()
    fig.savefig(os.path.join(args.dest_path, f"sorted_{args.metric}_scores.png"))
    fig.savefig(os.path.join(args.dest_path, f"sorted_{args.metric}_scores.pdf"))


def metric_box_plot(args, tables, pairs):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(2.2, 2.0) if args.fig_size is None else args.fig_size)
    data, tick_labels = [], []
    for root, label in pairs:
        data.append([s for _, s in video_scores(tables["videos"][root], tables[args.metric][root],
                                                args.summary_method)])
        tick_labels.append(label or root)
    ax.boxplot(data, vert=False, tick_labels=tick_labels, flierprops=dict(markersize=1))
    ax.set_xlabel(f"{args.metric.upper()} ({args.summary_method})")
    if args.range is not None:
        ax.set_xlim(args.range[0], args.range[1])
    if args.title:
        ax.set_title(args.title)
    fig.savefig(os.path.join(args.dest_path, f"boxplot_{args.metric}_scores.png"), bbox_inches="tight")
    fig.savefig(os.path.join(args.dest_path, f"boxplot_{args.metric}_scores.pdf"), bbox_inches="tight")


def metric_summary_text_file(args, tables, pairs):
    rows = metric_summary_rows(tables, pairs, args.metric, args.mean_precision, args.std_err_precision)
    out = render_table(["Model", "Mean", "StdErr"], rows)
    with open(os.path.join(args.dest_path, f"{args.metric}_perf_summary.txt"), "w") as f:
        f.write(out)


# Each subcommand and its flags.
SUBCOMMANDS = {
    "avg_metric_plot": (avg_metric_plot, ("quant_results_roots", "labels", "T", "range", "fig_size", "dest_path",
                                          "title", "metric")),
    "video_metric_text_file": (video_metric_text_file, ("quant_results_roots", "labels", "dest_path", "metric",
                                                        "summary_method")),
    "sorted_metric_plot": (sorted_metric_plot, ("quant_results_roots", "labels", "dest_path", "metric", "range",
                                                "fig_size", "title", "summary_method")),
    "metric_box_plot": (metric_box_plot, ("quant_results_roots", "labels", "dest_path", "metric", "range",
                                          "fig_size", "title", "summary_method")),
    "metric_summary_text_file": (metric_summary_text_file, ("quant_results_roots", "labels", "dest_path", "metric",
                                                            "mean_precision", "std_err_precision")),
}


def main(argv=None):
    parser = argparse.ArgumentParser()
    subs = parser.add_subparsers(dest="command")
    for name, (_, keys) in SUBCOMMANDS.items():
        _add(subs.add_parser(name), *keys)
    args, _ = parser.parse_known_args(argv)
    if args.command is None:
        parser.error("missing subcommand")

    labels = args.labels or [None] * len(args.quant_results_roots)
    if len(labels) != len(args.quant_results_roots):
        parser.error(f"{len(labels)} labels for {len(args.quant_results_roots)} --quant_results_roots")
    pairs = list(zip(args.quant_results_roots, labels))
    os.makedirs(args.dest_path, exist_ok=True)
    tables = load_all_tables(args.quant_results_roots)
    SUBCOMMANDS[args.command][0](args, tables, pairs)


if __name__ == "__main__":
    main()

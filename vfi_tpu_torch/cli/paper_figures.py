"""Registry-driven paper figure/image generation (counterpart of vfi_tpu's
``cli/paper_figures.py``, the modernized equivalent of the reference's
src/util/plots.py + src/util/images.py).

    python -m vfi_tpu_torch.cli.paper_figures register --dataset KTH --model bi-TAI --io_key 5_10 --exp_name E
    python -m vfi_tpu_torch.cli.paper_figures plot --dataset KTH --models bi-TAI --io_key 5_10
    python -m vfi_tpu_torch.cli.paper_figures images --clip_dirs DIR_A DIR_B --output strip.png

``register`` needs the standard library alone, ``images`` PIL, and ``plot``
matplotlib (an ``ImportError`` naming it where it is missing).
"""

import argparse
import os

from ..eval.records import ExperimentRegistry, image_strip, metric_plot_for_models


def main(argv=None):
    p = argparse.ArgumentParser()
    subs = p.add_subparsers(dest="command", required=True)

    reg = subs.add_parser("register", help="record a finished experiment")
    reg.add_argument("--registry", type=str, default="records/experiments.json")
    reg.add_argument("--dataset", type=str, required=True)
    reg.add_argument("--model", type=str, required=True)
    reg.add_argument("--io_key", type=str, required=True, help='e.g. "5_10" for K=5, K+T=10')
    reg.add_argument("--exp_name", type=str, required=True)

    plot = subs.add_parser("plot", help="metric-vs-timestep curves for registered models")
    plot.add_argument("--registry", type=str, default="records/experiments.json")
    plot.add_argument("--results_dir", type=str, default="results/")
    plot.add_argument("--output_dir", type=str, default="paper_plots")
    plot.add_argument("--dataset", type=str, required=True)
    plot.add_argument("--models", type=str, nargs="+", required=True)
    plot.add_argument("--io_key", type=str, required=True)
    plot.add_argument("--metrics", type=str, nargs="+", default=["psnr", "ssim"])

    strip = subs.add_parser("images", help="sliding image strips across experiments")
    strip.add_argument("--clip_dirs", type=str, nargs="+", required=True)
    strip.add_argument("--labels", type=str, nargs="+", default=None)
    strip.add_argument("--output", type=str, required=True)
    strip.add_argument("--skip", type=int, default=1)
    strip.add_argument("--start", type=int, default=0)

    args = p.parse_args(argv)
    if args.command == "register":
        ExperimentRegistry(args.registry).register(args.dataset, args.model, args.io_key, args.exp_name)
        print("registered")
    elif args.command == "plot":
        registry = ExperimentRegistry(args.registry)
        os.makedirs(args.output_dir, exist_ok=True)
        for metric in args.metrics:
            out = os.path.join(args.output_dir, f"{args.dataset}_{args.io_key}_{metric}.pdf")
            metric_plot_for_models(
                registry, args.results_dir, args.dataset, args.models, args.io_key, metric, out
            )
            print(f"wrote {out}")
    else:
        labels = args.labels or [os.path.basename(d) for d in args.clip_dirs]
        image_strip(args.clip_dirs, labels, args.output, args.skip, args.start)
        print(f"wrote {args.output}")


if __name__ == "__main__":
    main()

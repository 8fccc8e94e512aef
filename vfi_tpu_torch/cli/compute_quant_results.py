"""PNG prediction dirs -> results.npz (counterpart of ``cli/compute_quant_results.py``).

    python -m vfi_tpu_torch.cli.compute_quant_results QUAL_ROOT QUANT_ROOT K T [--depth 1] [--device cuda]

The metrics run on ``--device`` (default ``cuda``; without a GPU the CPU
must be asked for with ``--device cpu``).
"""

import argparse

from ..eval.quant import compute_quant_results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("qual_results_root", type=str)
    p.add_argument("quant_results_root", type=str)
    p.add_argument("K", type=int)
    p.add_argument("T", type=int)
    p.add_argument("--depth", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda", help="torch device of the metrics ('cuda' or 'cpu')")
    args = p.parse_args(argv)
    print("Now computing quantitative results...")
    compute_quant_results(args.qual_results_root, args.quant_results_root, args.K, args.T, args.depth,
                          device=args.device)
    print("Done computing quantitative results.")


if __name__ == "__main__":
    main()

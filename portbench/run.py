"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a profiled window.  The last lines
of standard error, and the ``checks`` of the result line, give each number
of the correctness check beside its limit.  Exits non-zero, printing no
result, without enough CUDA devices, or when the process holds JAX or the
JAX package.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

from .bench import PKG, IsolationError, check_isolation, entry, load_cell, metric_reader, result_line
from .judge import verdict

# Caches of anything the run compiles stay at fixed paths of the checkout
# (the port's nvcc libraries go to vfi_tpu_torch/_build/ by themselves).
os.environ["TRITON_CACHE_DIR"] = str(PKG / "_cache" / "triton")


class Reading:
    """What a per-layer metric's ``read`` gets: the trace and the cell's counts."""

    def __init__(self, trace, counts: dict):
        self.trace, self.counts = trace, counts


def _num(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    check_isolation()
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    res = entry(cell).run(cell, args.seed, args.seconds, bool(args.trace), device)

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if args.trace:
        reading = Reading(res["trace"], res["counts"])
        values = {m["name"]: metric_reader(cell, m["name"])(reading) for m in cell.per_layer}
    else:
        values = {m["name"]: res["e2e"][m["name"]] for m in cell.end_to_end}
    metrics = {n: {"value": _num(v), "unit": units[n]} for n, v in values.items() if v is not None}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell.chips,
           "memory_peak_bytes": int(res["memory_peak_bytes"])}
    breakdown = None
    if args.trace:
        dev["busy_s"], dev["window_s"] = res["trace"].busy_s, res["trace"].window_s
        breakdown = res["trace"].breakdown()
    correct = verdict(res["checks"]) and res["failed"] == 0
    try:
        check_isolation()
    except IsolationError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 4
    for name, (value, limit) in res["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    checks = {n: {"value": _num(v), "limit": lim} for n, (v, lim) in res["checks"].items()}
    sys.stderr.flush()
    print(result_line(correct, res["attempted"], res["failed"], metrics, dev, checks, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings of the correctness check for the program and for its control,
on many seeds in one process (the numbers each limit is set from).

    python3 -m portbench.control --workload <name> --seeds 1 2 3 --seconds 3 [--control]

The control is what the check has to refuse: for a bf16 serving cell the
port's own int8 path (``program_int8``), for an int8 serving cell the
reference with int4 convs in the program's place (``reference_int4``), for
a bf16 training cell the reference with fp8 conv operands in the program's
place (``reference_fp8``).  ``--fault`` plants one of ``faults.py``'s faults under the program
instead.  Each reading is one JSON line.  Training runs only its three checked
steps; serving a window of ``--seconds``.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import faults
from .bench import check_isolation, entry, load_cell
from .judge import verdict


def control_of(cell) -> str:
    if cell.traffic["entry"] == "train":
        return "reference_fp8"
    return "reference_int4" if cell.traffic.get("quantize", "none") != "none" else "program_int8"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=int, default=3)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(faults.SERVE) + sorted(faults.TRAIN),
                    help="plant this fault under the program's call instead")
    args = ap.parse_args(argv)
    check_isolation()
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA device", file=sys.stderr)
        return 3
    control = control_of(cell) if args.control else None
    hooks = None
    if args.fault:
        key = "train_step" if args.fault in faults.TRAIN else "inpaint"
        hooks = {key: {**faults.SERVE, **faults.TRAIN}[args.fault]}
    for seed in args.seeds:
        res = entry(cell).run(cell, seed, args.seconds, False, torch.device("cuda", 0), hooks=hooks,
                              control=control, check_only=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "side": control or args.fault or "program",
                          "correct": verdict(res["checks"]) and res["failed"] == 0, "readings": res["readings"],
                          "e2e": res["e2e"], "attempted": res["attempted"], "failed": res["failed"]}), flush=True)
    check_isolation()
    return 0


if __name__ == "__main__":
    sys.exit(main())

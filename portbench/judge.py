"""The comparison that decides ``correct``: what the timed path produced
against the plain reference, each number beside its limit
(``portbench/limits/<workload>.json``; a cell compares the numbers its
limits name).

Serving.  The served uint8 frames of the checked requests against the
reference's frames before rounding (``clip((pred+1)/2, 0, 1) * 255``).  A
served value is the reference's plus the program's error plus a rounding
error spread evenly over [-0.5, 0.5], of mean square 1/12; so
``sqrt(mean(err^2) - 1/12)`` over every checked pixel that the clip to
[0, 255] leaves alone is the program's RMS error in uint8 levels, rounding
taken out (``rms_u8``).  With random weights that error scales with how
strongly each seed's network amplifies rounding: 4x from seed to seed at
bf16, and the int8 control's with it.  ``rms_vs_bf16`` divides it by the
RMS error of the reference itself run in bfloat16 (the same pixels, against
the float32 reference; int8 cells: against the float32 reference too),
which follows the seed alike.  The readings each limit was set from are in
PERF.md.

Training.  The program's first three steps against the reference's from the
same weights, batches and lengths.  ``loss_rel_first``: the larger relative
gap of the first step's G and D losses (``loss_rel``, over all three steps,
is read beside it: after one Adam step bf16 and float32 part on near-zero
gradients, and on two seeds of twelve it read 10x the others).  Each
network, the generator (``G``) and the discriminator (``D``), is held on
its own, since G has about ten times D's leaves and one median over both
would not move with D.  ``grad_gap_G`` / ``grad_gap_D``: over the
network's leaves, the median of the gap between the norms of the first
gradient (the program's read from Adam's first moment after one step,
``exp_avg / (1 - beta1)``), each over the larger of the reference's norm of
that leaf and the network's median leaf's.  ``update_gap_G`` /
``update_gap_D``: the same of the parameters' change over the three steps,
leaving out leaves whose reference gradient is under a thousandth of the
network's median leaf's (moved by round-off alone under Adam).  The median,
not the worst leaf: the worst leaf of a sound bf16 step is a different
small leaf on each seed (``*_worst``, read beside it).  As in serving, the
first gradient's gap follows how strongly each seed's network amplifies
rounding, and the fp8 control's with it: ``grad_vs_bf16_G`` /
``grad_vs_bf16_D`` are the mean over the network's leaves of the first
gradient's gap, over the same mean of the reference's first step run in
bfloat16 (``grad_yard_*``).  Over a dozen seeds the mean's ratio parted
the fp8 control from sound steps, the median's did not (PERF.md).
"""

from __future__ import annotations

import math
import statistics

import numpy as np

ROUNDING_MS = 1.0 / 12.0
SMALL_GRAD = 1e-3


def _kept(ref: np.ndarray) -> np.ndarray:
    return (ref > 0.5) & (ref < 254.5)


def _sums(pairs, rounded: bool):
    """(sum of squared errors, pixels) over the pixels the clip leaves alone;
    None where a served answer has the wrong shape or type."""
    se, n = 0.0, 0
    for got, ref in pairs:
        if got.shape != ref.shape or (rounded and got.dtype != np.uint8):
            return None
        keep = _kept(ref)
        err = got.astype(np.float64)[keep] - ref[keep]
        se, n = se + float(np.sum(err * err)), n + err.size
    return (se, n) if n else None


def serve_numbers(pairs, bf16_pairs=None) -> dict:
    """``pairs``: (served uint8 ``[B, T, H, W, C]``, reference values of the
    same shape); ``bf16_pairs``: (the bfloat16 reference's values, the float32
    reference's), for ``rms_vs_bf16``."""
    sums = _sums(pairs, rounded=True)
    rms = math.inf if sums is None else math.sqrt(max(sums[0] / sums[1] - ROUNDING_MS, 0.0))
    numbers = {"rms_u8": rms}
    if bf16_pairs is not None:
        yard = _sums(bf16_pairs, rounded=False)
        numbers["bf16_rms_u8"] = math.inf if yard is None else math.sqrt(yard[0] / yard[1])
        numbers["rms_vs_bf16"] = rms / numbers["bf16_rms_u8"] if numbers["bf16_rms_u8"] > 0 else math.inf
    return numbers


def _leaf_gaps(prog: dict, ref: dict, keys) -> list:
    med = statistics.median(ref[k] for k in keys)
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]
    return gaps if all(math.isfinite(g) for g in gaps) else [math.inf]


NETWORKS = ("G", "D")


def train_numbers(prog: dict, ref: dict, yard: dict = None) -> dict:
    """``prog`` and ``ref``: ``losses`` (per step, ``{"G": x, "D": y}``),
    ``grad`` and ``update`` (per leaf name ``G.<name>`` or ``D.<name>``, a
    norm); ``yard``: the bfloat16 reference's ``grad``, for ``grad_vs_bf16_*``."""
    steps = [[abs(p[k] - r[k]) / max(abs(r[k]), 1e-30) for k in r] for p, r in zip(prog["losses"], ref["losses"])]
    gaps = [g for step in steps for g in step]
    loss_rel = max(gaps) if gaps and all(math.isfinite(g) for g in gaps) else math.inf
    if len(prog["losses"]) != len(ref["losses"]):
        loss_rel = math.inf
    # The first step's, and each network's worst leaf, read beside the compared numbers (PERF.md gives both).
    out = {"loss_rel": loss_rel, "loss_rel_first": max(steps[0]) if steps else math.inf}
    for net in NETWORKS:
        leaves = [k for k in ref["grad"] if k.startswith(net + ".")]
        med = statistics.median(ref["grad"][k] for k in leaves)
        moved = [k for k in leaves if ref["grad"][k] >= SMALL_GRAD * med]
        grad, update = _leaf_gaps(prog["grad"], ref["grad"], leaves), _leaf_gaps(prog["update"], ref["update"], moved)
        out.update({f"grad_gap_{net}": statistics.median(grad), f"update_gap_{net}": statistics.median(update),
                    f"grad_gap_{net}_worst": max(grad), f"update_gap_{net}_worst": max(update)})
        if yard is not None:
            mean = statistics.fmean(grad)
            out[f"grad_yard_{net}"] = statistics.fmean(_leaf_gaps(yard["grad"], ref["grad"], leaves))
            out[f"grad_vs_bf16_{net}"] = mean / out[f"grad_yard_{net}"] if out[f"grad_yard_{net}"] > 0 else math.inf
    return out


def checks(numbers: dict, limits: dict) -> dict:
    """The numbers a cell's limits name, each as (value, limit); one the
    readings lack reads infinite."""
    return {k: (numbers.get(k, math.inf), lim) for k, lim in limits.items()}


def verdict(checks: dict) -> bool:
    """Correct where every number lies at or under its limit (a NaN never does)."""
    return all(v <= lim for v, lim in checks.values())

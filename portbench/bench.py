"""What every run shares: the cell found by name from ``BENCHMARK.json`` and
the files under ``portbench/``, the process clock, the isolation check and
the result line.

A cell is a workload of ``BENCHMARK.json``: its configuration
(``configs[].file``), its traffic mix (``portbench/traffic/<traffic>.json``),
the limits of its correctness check (``portbench/limits/<workload>.json``)
and the metrics it reports (the end-to-end and per-layer metrics whose
``workloads`` name it, or that name none).  The traffic's ``entry`` names the
driver, ``portbench/entries/<entry>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

PKG = Path(__file__).resolve().parent
REPO = PKG.parent
# Top-level module names the benchmark's process may never hold: the JAX
# package the port was made from, and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "vfi_tpu")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list
    per_layer: list
    metrics_dir: Path = field(default=PKG / "metrics")


def _for(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def load_cell(name: str, repo: Path = REPO) -> Cell:
    """The workload ``name`` of ``repo/BENCHMARK.json`` with its files."""
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(work)}")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    pkg = repo / "portbench"
    return Cell(
        name=name,
        config=json.loads((repo / cfg["file"]).read_text()),
        traffic=json.loads((pkg / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((pkg / "limits" / f"{name}.json").read_text()),
        chips=w["chips"],
        end_to_end=[m for m in bench["end_to_end"] if _for(m, name)],
        per_layer=[m for m in bench["per_layer"] if _for(m, name)],
        metrics_dir=pkg / "metrics",
    )


def entry(cell: Cell):
    """The driver module of the cell's traffic."""
    return importlib.import_module(f"portbench.entries.{cell.traffic['entry']}")


def metric_reader(cell: Cell, name: str):
    """``read`` of ``metrics/<name>.py``, loaded by path (metric names hold dots)."""
    path = cell.metrics_dir / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time, at clock-tick resolution)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN})


class IsolationError(RuntimeError):
    pass


def check_isolation() -> None:
    found = forbidden_modules()
    if found:
        raise IsolationError(f"forbidden modules loaded in the benchmark's process: {found}")


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict, checks: dict,
                breakdown=None) -> str:
    """The run's last line of standard output.  ``checks`` (each number compared
    with its limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)

"""The check refuses what it must: a run at a tiny size on the CPU, its
harness driven whole, with the timed path broken underneath, and each cell's
control in the program's place.  Sound runs at the same size pass."""

from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import bench, faults
from portbench.control import control_of
from portbench.judge import verdict
from portbench.tests import tiny

SEED = 3
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(Path(tmp_path_factory.mktemp("tiny")))


def _run(root, workload, **kw):
    cell = bench.load_cell(workload, root)
    out = bench.entry(cell).run(cell, SEED, 1, False, CPU, **kw)
    return verdict(out["checks"]) and out["failed"] == 0, out


@pytest.mark.parametrize("workload", ["tai_gray.serve_b64", "tai_color.serve_b16", "tai_gray.serve_int8_b64",
                                      "tai_gray.train_sampled_b32"])
def test_sound_run_and_its_control(root, workload):
    ok, out = _run(root, workload)
    assert ok, out["checks"]
    assert out["attempted"] > 0 and all(v > 0 for v in out["e2e"].values())
    ok, out = _run(root, workload, control=control_of(bench.load_cell(workload, root)), check_only=True)
    assert not ok, out["checks"]


@pytest.mark.parametrize("fault", [faults.altered, faults.swapped])
def test_serve_answer_altered(root, fault):
    ok, out = _run(root, "tai_gray.serve_b64", hooks={"inpaint": fault})
    assert not ok, out["checks"]


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_train_step_broken(root, fault):
    ok, out = _run(root, "tai_gray.train_sampled_b32", hooks={"train_step": faults.TRAIN[fault]})
    assert not ok, out["checks"]
    if fault.endswith("unchanged"):
        nets = ("G", "D") if fault == "unchanged" else ("D",)
        # About 1: a leaf under the network's median leaf reads its share of that median.
        assert all(out["checks"][f"update_gap_{n}"][0] > 0.8 for n in nets), out["checks"]
    if fault.startswith("d_"):  # a fault of D's update leaves G's numbers as a sound step's
        assert out["checks"]["grad_vs_bf16_G"][0] <= out["checks"]["grad_vs_bf16_G"][1], out["checks"]


def test_failed_requests_are_not_correct(root):
    def broken(inpaint):
        def call(pre, fol, T):
            raise RuntimeError("planted")
        return call
    ok, out = _run(root, "tai_gray.serve_b64", hooks={"inpaint": broken})
    assert not ok and out["failed"] == out["attempted"] > 0


def test_judge_takes_rounding_out():
    """Served frames that are the reference's rounded read 0; a shift of one level reads about 1."""
    from portbench.judge import serve_numbers

    ref = np.random.default_rng(0).uniform(10, 240, (2, 3, 16, 16, 1))
    exact = serve_numbers([(np.round(ref).astype(np.uint8), ref)])["rms_u8"]
    off = serve_numbers([(np.round(ref + 1).astype(np.uint8), ref)], [(ref + 0.5, ref)])
    assert exact < 0.05 and 0.9 < off["rms_u8"] < 1.1 and 1.8 < off["rms_vs_bf16"] < 2.2

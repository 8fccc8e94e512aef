"""On the card, at each cell's own size: the program passes its check and the
cell's control fails it, on three seeds (the readings the limits were set
from; ``python3 -m portbench.control`` prints them)."""

import pytest

from portbench import bench
from portbench.control import control_of
from portbench.judge import verdict

WORKLOADS = ["tai_gray.serve_b64", "tai_color.serve_b16", "tai_gray.train_sampled_b32", "tai_gray.serve_int8_b64"]


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_program_passes(cuda_device, workload):
    cell = bench.load_cell(workload)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        prog = bench.entry(cell).run(cell, seed, 3, False, cuda_device, check_only=True)
        ctl = bench.entry(cell).run(cell, seed, 3, False, cuda_device, control=control_of(cell), check_only=True)
        assert verdict(prog["checks"]) and prog["failed"] == 0, (seed, prog["checks"])
        assert not verdict(ctl["checks"]), (seed, ctl["checks"])

"""The result line, and the runs that must print none."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import run
from portbench.bench import PKG, REPO, result_line


def test_result_line_keys_checks_last():
    line = result_line(True, 10, 0, {"setup_s": {"value": 1.5, "unit": "s"}},
                       {"platform": "gpu", "kind": "X", "count": 1, "memory_peak_bytes": 5},
                       {"clip_rms_u8": {"value": 0.2, "limit": 1.0}}, {"device_ops": [], "idle_gaps": []})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert out["correct"] is True and out["checks"]["clip_rms_u8"] == {"value": 0.2, "limit": 1.0}


def test_no_cuda_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "tai_gray.serve_b64", "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "needs 1 CUDA device" in out.err


def test_only_benchmark_files_no_result(tmp_path):
    """A directory with BENCHMARK.json and portbench/ alone runs nothing: exit code not 0, no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(PKG, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "tai_gray.serve_b64", "--seed", "5",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, env=env,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("bad", [["--trace", "2"], ["--seed", "x"]])
def test_bad_arguments(bad):
    args = {"--workload": "tai_gray.serve_b64", "--seed": "1", "--seconds": "1", "--trace": "0"}
    args[bad[0]] = bad[1]
    with pytest.raises(SystemExit):
        run.main([a for kv in args.items() for a in kv])

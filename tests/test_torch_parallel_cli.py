"""The port's train and predict CLIs launched by torchrun as two gloo ranks on
the CPU (``python -m torch.distributed.run --nproc_per_node 2 -m
vfi_tpu_torch.cli.train ... --device cpu``), against the same CLIs in one
process.  Marked slow (about 90 s: three launches of two fresh interpreters,
and TensorBoard's import, which loads TensorFlow, in each rank 0)."""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from vfi_tpu_torch.cli import predict, train as train_cli
from vfi_tpu_torch.data.synthetic import make_videolist
from vfi_tpu_torch.utils.png import read_png
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

pytestmark = pytest.mark.slow

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SPEC = json.dumps({"class": "TAIFillInModel", "args": [],
                   "kwargs": {"gf_dim": 8, "c_dim": 1, "ks": 5, "num_block": 5, "kf_dim": 4}})
K = T = F = 2
HW = 32
LOCAL_B = 2
TERMS = ("G_Lp", "G_gdl", "G_GAN", "G_Lp_forward", "G_Lp_backward", "G_gdl_forward", "G_gdl_backward", "G_loss",
         "D_fake", "D_real")


def torchrun(module: str, args: list) -> str:
    """``module`` under torchrun with two ranks on the CPU; its output."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2", "-m", module,
           *args, "--device", "cpu"]
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, f"stdout:\n{r.stdout[-4000:]}\nstderr:\n{r.stderr[-8000:]}"
    return r.stdout


def train_args(root: str, name: str, lists: dict, batch: int, max_iter: int) -> list:
    """Data in order: clips of exactly K+T+F frames, no shuffle, flip or reversal."""
    return ["--name", name, "--model_key", SPEC, "--K", str(K), "--T", str(T), "--F", str(F), "--alt_K", "3",
            "--alt_T", "3", "--alt_F", "3", "--c_dim", "1", "--image_size", str(HW), "--batch_size", str(batch),
            "--train_video_list_path", lists["train"], "--val_video_list_path", lists["val"],
            "--max_iter", str(max_iter), "--print_freq", "1", "--save_latest_freq", "2", "--validate_freq", "2",
            "--df_dim", "8", "--Ip", "1", "--serial_batches", "--no_flip", "--no_backwards", "--num_threads", "0",
            "--checkpoints_dir", os.path.join(root, "ckpt"), "--tensorboard_dir", os.path.join(root, "tb"),
            "--log_json", os.path.join(root, f"{name}.jsonl")]


def events(root: str, name: str, kind: str) -> list:
    with open(os.path.join(root, f"{name}.jsonl")) as f:
        return [e for e in map(json.loads, f) if e["event"] == kind]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two ranks at local B=2: 4 iterations, then a resume to 6; one process at
    B=4 for 3 iterations from the same fresh init."""
    root = str(tmp_path_factory.mktemp("parallel_cli"))
    lists = {"train": make_videolist(os.path.join(root, "train"), 12, seed=3, n_frames=K + T + F, hw=HW),
             "val": make_videolist(os.path.join(root, "val"), 5, seed=4, n_frames=K + T + F, hw=HW)}
    out = [torchrun("vfi_tpu_torch.cli.train", train_args(root, "ddp", lists, LOCAL_B, n)) for n in (4, 6)]
    one = train_cli.main(train_args(root, "one", lists, 2 * LOCAL_B, 3) + ["--device", "cpu"])
    return dict(root=root, lists=lists, out=out, one=one)


def test_two_ranks_train_as_one_process_at_twice_the_batch(runs):
    root = runs["root"]
    got, want = events(root, "ddp", "iter")[:3], events(root, "one", "iter")
    assert [e["iter"] for e in got] == [e["iter"] for e in want] == [1, 2, 3]
    for g, w in zip(got, want):
        for k in TERMS:
            assert abs(g[k] - w[k]) <= 1e-3 * abs(w[k]), (g["iter"], k, g[k], w[k])
    assert "torch.distributed: 2 ranks, backend gloo" in runs["out"][0]
    assert "global batch 4" in runs["out"][0]


def test_only_rank0_writes_and_the_resume_is_broadcast(runs):
    root = runs["root"]
    iters = events(root, "ddp", "iter")
    assert [e["iter"] for e in iters] == [1, 2, 3, 4, 5, 6]  # one rank's events, not two
    assert [e["iter"] for e in events(root, "ddp", "resume")] == [4]
    assert len(events(root, "ddp", "done")) == 2
    assert len(glob.glob(os.path.join(root, "tb", "ddp", "events.out.tfevents.*"))) == 2
    assert {"model_latest.ckpt", "model_00000002.ckpt", "model_00000004.ckpt", "model_00000006.ckpt",
            "model_best.ckpt", "train_opt.txt"} <= set(os.listdir(os.path.join(root, "ckpt", "ddp")))
    assert all(out.count("training done") == 1 for out in runs["out"])


def test_uneven_validation_shards_give_every_row(runs):
    """5 validation clips over 2 ranks (3 and 2) at iterations 2, 4 and 6."""
    vals = events(runs["root"], "ddp", "val")
    assert [(e["iter"], e["videos"]) for e in vals] == [(2, 5), (4, 5), (6, 5)]
    one = events(runs["root"], "one", "val")
    assert one[0]["videos"] == 5 and abs(vals[0]["ssim"] - one[0]["ssim"]) <= 1e-3 * abs(one[0]["ssim"]) + 1e-6


def test_two_ranks_predict_the_one_process_tree(runs):
    root = runs["root"]
    ckpt_dir = os.path.join(root, "ckpt")
    args = ["--K", str(K), "--T", str(T), "--F", str(F), "--c_dim", "1", "--image_size", str(HW),
            "--batch_size", "2", "--model_key", SPEC, "--name", "ddp", "--checkpoints_dir", ckpt_dir,
            "--snapshot_file_name", "model_latest.ckpt", "--test_video_list_path", runs["lists"]["train"],
            "--num_threads", "0"]
    out = torchrun("vfi_tpu_torch.cli.predict", args + ["--qual_result_root", os.path.join(root, "qual_ddp")])
    predict.main(args + ["--qual_result_root", os.path.join(root, "qual_one"), "--device", "cpu"])
    trees = {}
    for tag in ("ddp", "one"):
        q = os.path.join(root, f"qual_{tag}")
        trees[tag] = {c: sorted(os.listdir(os.path.join(q, c))) for c in sorted(os.listdir(q))}
    assert trees["ddp"] == trees["one"] and len(trees["one"]) == 12
    worst = 0
    for clip, files in trees["one"].items():
        for name in files:
            a, b = (read_png(os.path.join(root, f"qual_{t}", clip, name)).astype(np.int16) for t in ("ddp", "one"))
            worst = max(worst, int(np.abs(a - b).max()))
    assert worst <= 1
    assert "[rank 0] processed 6/6 clips" in out and "[rank 1] processed 6/6 clips" in out
    assert "all 2 ranks: 12 of 12 clips predicted" in out


def test_two_ranks_share_rank0s_int8_scales_and_gate(runs, capsys):
    """--quantize int8: rank 0 calibrates and runs the gate; both ranks print
    the same scales as one process and the gate's verdict."""
    root = runs["root"]
    args = ["--K", str(K), "--T", str(T), "--F", str(F), "--c_dim", "1", "--image_size", str(HW),
            "--batch_size", "2", "--model_key", SPEC, "--name", "ddp", "--checkpoints_dir", os.path.join(root, "ckpt"),
            "--snapshot_file_name", "model_latest.ckpt", "--test_video_list_path", runs["lists"]["train"],
            "--num_threads", "0", "--quantize", "int8", "--force_quant"]
    out = torchrun("vfi_tpu_torch.cli.predict", args + ["--qual_result_root", os.path.join(root, "qual_int8_ddp")])
    predict.main(args + ["--qual_result_root", os.path.join(root, "qual_int8_one"), "--device", "cpu"])
    one = capsys.readouterr().out
    digest = [ln.split()[-1] for ln in one.splitlines() if "int8 activation scales sha256" in ln]
    assert len(digest) == 1
    for r in (0, 1):
        assert f"[rank {r}] int8 activation scales sha256 {digest[0]}" in out
        assert f"[rank {r}] validate_quant verdict of rank 0: " in out
    assert out.count("int8 activation scales calibrated on 8 clips") == 1 and out.count("validate_quant (") == 1

"""vfi_tpu_torch.cli.predict and compute_quant_results against vfi_tpu's CLIs
on the CPU: a toy TAI snapshot written by vfi_tpu, converted to the port's
layout by scripts/convert_checkpoint_torch.py, and synthetic clips of exactly
K+T+F frames (so the contiguous crop is the whole clip).

vfi_tpu's cli/predict.py runs once, in a subprocess (JAX on the CPU, one
device), with --intermediate_preds --device_normalize; 3 clips at batch size
2 make a ragged final batch, padded.  The port runs in-process with --device
cpu, in each mode, against that run.  Gate: the same PNG files, and pixels
within 1 uint8 level (f32 forwards of two frameworks, rounded to uint8 at the
PNG write).  The disjoint videolist names the same frames as the contiguous
one (preceding 1-K, following K+T+1-K+T+F), so the port's --disjoint_clips
run is held to the same PNGs under the disjoint labels (its dataset is held
to vfi_tpu's in test_torch_data.py)."""

import glob
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from scripts.convert_checkpoint_torch import to_torch_payload
from vfi_tpu.eval.quant import compute_quant_results as jax_quant_results
from vfi_tpu.train import environments as jenvs
from vfi_tpu.utils import checkpoint as jckpt
from vfi_tpu.utils.config import TrainConfig as JTrainConfig
from vfi_tpu_torch.cli import compute_quant_results as quant_cli
from vfi_tpu_torch.cli import predict
from vfi_tpu_torch.data.synthetic import make_videolist
from vfi_tpu_torch.utils import checkpoint as tckpt
from vfi_tpu_torch.utils.config import TrainConfig
from vfi_tpu_torch.utils.params import random_jax_disc_variables, random_jax_params
from vfi_tpu_torch.utils.png import read_png
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
K = T = F = 2
HW, N_CLIPS, BATCH = 32, 3, 2
SPEC = {"class": "TAIFillInModel", "args": [],
        "kwargs": dict(gf_dim=8, c_dim=1, feature_size=3, ks=5, num_block=5, kf_dim=4, layers=3)}
NAME = "toy_tai"


def _common(root, videolist, qual):
    return ["--K", str(K), "--T", str(T), "--F", str(F), "--c_dim", "1", "--image_size", str(HW),
            "--batch_size", str(BATCH), "--model_key", json.dumps(SPEC), "--name", NAME,
            "--checkpoints_dir", os.path.join(root, "ckpt_" + ("jax" if qual.endswith("_jax") else "torch")),
            "--test_video_list_path", videolist, "--qual_result_root", qual, "--num_threads", "0"]


def _run_jax_predict(args):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO, "XLA_FLAGS": ""}
    r = subprocess.run([sys.executable, os.path.join(REPO, "cli", "predict.py")] + args, cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return r.stdout


def jax_snapshot(save_dir, name, spec, cfg, hw, seed):
    """A vfi_tpu training snapshot with random weights (``random_jax_params``,
    ``random_jax_disc_variables``), fresh Adam states and the rng of
    ``init_state(PRNGKey(0))``, built without tracing the model."""
    g = jax.tree.map(jax.numpy.asarray, random_jax_params(spec, seed))
    d = jax.tree.map(jax.numpy.asarray, random_jax_disc_variables(cfg, hw, hw, spec["kwargs"]["c_dim"], seed + 1))
    jenv = jenvs.L2GDLDiscEnvironment(None, JTrainConfig(K=cfg.K, T=cfg.T, F=cfg.F))
    state = jenvs.TrainState(step=jax.numpy.zeros((), jax.numpy.int32), g_params=g, g_opt=jenv.g_tx().init(g),
                             d_params=d["params"], d_sn=d["sn"], d_opt=jenv.d_tx().init(d["params"]),
                             rng=jax.random.split(jax.random.PRNGKey(0), 3)[2])
    jckpt.save_snapshot(save_dir, name, state, {"updates": 0, "sum_avg_psnr_err": 0.0, "sum_avg_ssim_err": 0.0})
    return jckpt._checkpointer().restore(os.path.abspath(os.path.join(save_dir, name)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """vfi_tpu's run, on a vfi_tpu snapshot; the port's snapshot is its conversion."""
    root = str(tmp_path_factory.mktemp("predict"))
    videolist = make_videolist(os.path.join(root, "clips"), N_CLIPS, seed=3, n_frames=K + T + F, hw=HW)
    disjoint = os.path.join(root, "disjoint.txt")
    with open(videolist) as f, open(disjoint, "w") as g:
        g.writelines(f"{ln.split()[0]} 1-{K} {K + T + 1}-{K + T + F}\n" for ln in f if ln.strip())

    raw = jax_snapshot(os.path.join(root, "ckpt_jax", NAME), "model_best.ckpt", SPEC,
                       TrainConfig(K=K, T=T, F=F, df_dim=8, Ip=1), HW, seed=7)
    tckpt.write_payload(os.path.join(root, "ckpt_torch", NAME), "model_best.ckpt",
                        to_torch_payload(raw["state"], raw["counters"], json.dumps(SPEC)))
    qual = os.path.join(root, "contiguous_jax")
    stdout = _run_jax_predict(_common(root, videolist, qual) + ["--intermediate_preds", "--device_normalize"])
    return dict(root=root, videolist=videolist, disjoint=disjoint, jax=(qual, stdout))


def _port(runs, mode, lst, extra, capsys):
    qual = os.path.join(runs["root"], f"{mode}_torch")
    stats = predict.main(_common(runs["root"], lst, qual) + ["--device", "cpu"] + extra)
    return qual, stats, capsys.readouterr().out


def _disjoint_label(label):
    """vfi_tpu's contiguous label ``<clip>_1-<K+T+F>`` -> the disjoint label of the same frames."""
    return f"{label.rsplit('_', 1)[0]}_1-{K}_{K + T + 1}-{K + T + F}"


def _assert_same_pngs(got_root, want_root, disjoint=False):
    clips = sorted(os.listdir(want_root))
    assert len(clips) == N_CLIPS
    assert sorted(os.listdir(got_root)) == sorted(_disjoint_label(c) if disjoint else c for c in clips)
    n, worst = 0, 0
    for clip in clips:
        got_clip = _disjoint_label(clip) if disjoint else clip
        names = sorted(os.listdir(os.path.join(got_root, got_clip)))
        want_names = os.listdir(os.path.join(want_root, clip))
        if disjoint:  # no GT middle frames and no intermediate outputs
            want_names = [m for m in want_names if m.startswith(("gt_preceding_", "gt_following_"))
                          or re.fullmatch(r"pred_middle_\d+\.png", m)]
        assert names == sorted(want_names), clip
        for name in names:
            a = read_png(os.path.join(got_root, got_clip, name)).astype(np.int16)
            b = read_png(os.path.join(want_root, clip, name)).astype(np.int16)
            assert a.shape == b.shape == (HW, HW), (clip, name)
            worst = max(worst, int(np.abs(a - b).max()))
            n += 1
    assert worst <= 1, worst
    return n


@pytest.mark.parametrize("mode", ["contiguous_intermediate_device_normalize", "contiguous_host_normalize",
                                  "disjoint", "unpadded_ragged_batch"])
def test_predict_pngs_match_vfi_tpu(runs, mode, capsys):
    """Each mode against vfi_tpu's run of the same clips (--intermediate_preds
    --device_normalize): the same flags; the host-normalized float pipeline
    (vfi_tpu's own tests hold its two pipelines within 1 level);
    --disjoint_clips; --no_pad_final_batch."""
    want, jax_stdout = runs["jax"]
    extra = {"contiguous_intermediate_device_normalize": ["--intermediate_preds", "--device_normalize"],
             "contiguous_host_normalize": ["--intermediate_preds"],
             "disjoint": ["--disjoint_clips"],
             "unpadded_ragged_batch": ["--intermediate_preds", "--no_pad_final_batch"]}[mode]
    lst = runs["disjoint"] if mode == "disjoint" else runs["videolist"]
    got, stats, stdout = _port(runs, mode, lst, extra, capsys)
    per_clip = K + T + F if mode == "disjoint" else K + 2 * T + F + 4 * T  # + gt_middle, 4 intermediate outputs
    assert _assert_same_pngs(got, want, disjoint=mode == "disjoint") == N_CLIPS * per_clip
    pad_line = f"padded final batch 1 -> {BATCH}"
    assert (pad_line in stdout) == (mode != "unpadded_ragged_batch") and pad_line in jax_stdout
    assert f"predicted {N_CLIPS} clips in" in stdout and "inflight=2" in stdout
    assert stats["clips"] == N_CLIPS and stats["batches"] == 2


def test_quant_results_match_vfi_tpu(runs, tmp_path):
    """results.npz of the port's compute_quant_results against vfi_tpu's on
    the same PNG folders (vfi_tpu's contiguous run): PSNR within 1e-4 dB,
    SSIM within 1e-6, the same video list."""
    qual = runs["jax"][0]
    quant_cli.main([qual, str(tmp_path / "port"), str(K), str(T), "--device", "cpu"])
    want = jax_quant_results(qual, str(tmp_path / "jax"), K, T)
    got = np.load(tmp_path / "port" / "results.npz")
    assert got["psnr"].shape == want["psnr"].shape == (N_CLIPS, T)
    assert list(got["video"]) == list(want["video"])
    np.testing.assert_allclose(got["psnr"], want["psnr"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["ssim"], want["ssim"], atol=1e-6, rtol=0)


def test_profile_steps_write_a_trace(runs, capsys):
    """--profile_steps 1 99: the trace window opens at batch 1 and is closed
    at the end of the short run."""
    trace_dir = os.path.join(runs["root"], "trace")
    _, stats, stdout = _port(runs, "profiled", runs["videolist"],
                             ["--profile_steps", "1", "99", "--profile_dir", trace_dir], capsys)
    assert stats["trace"] and os.path.isfile(stats["trace"]) and os.path.dirname(stats["trace"]) == trace_dir
    assert glob.glob(os.path.join(trace_dir, "*.json")) and "profiler trace written to" in stdout
    with open(stats["trace"]) as f:
        assert json.load(f)["traceEvents"]


def test_predict_needs_the_cpu_asked_for_without_a_gpu(runs, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _common(runs["root"], runs["videolist"], str(tmp_path / "qual"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predict.main(args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predict.main(args + ["--device", "cuda"])
    monkeypatch.setenv("WORLD_SIZE", "2")  # an unported run (--quantize is ported since int8 serving)
    with pytest.raises(NotImplementedError, match="item 9"):
        predict.main(args + ["--device", "cpu"])
    assert not os.path.exists(tmp_path / "qual")


def test_predict_restores_the_tf32_settings(runs, capsys, tmp_path):
    """--dtype float32 (the default) runs with TF32 off and puts both settings
    back when main returns, and when it raises (here: no snapshot)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        _, stats, stdout = _port(runs, "tf32", runs["videolist"], [], capsys)
        assert "TF32: matmul False, cudnn False" in stdout and stats["clips"] == N_CLIPS
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        args = _common(runs["root"], runs["videolist"], str(tmp_path / "qual"))
        with pytest.raises(FileNotFoundError, match="no snapshot"):
            predict.main(args + ["--device", "cpu", "--checkpoints_dir", str(tmp_path / "none")])
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

"""The model zoo through the port's CLIs on the CPU, at toy widths named by
JSON model keys: Super SloMo (base_dim 4, color 32x32, a seeded VGG16 .npz)
and SCT Forward (d_v 16, gray 32x32).

Each model trains through ``vfi_tpu_torch.cli.train`` for 2 iterations with
a snapshot and a validation sweep at 2, then resumes to 3; a run of 3
iterations without the resume is its reference: the resumed iteration's
terms must equal it (weights, Adam moments and step restored, SloMo's rate
read from the restored step, SCT's generator restored; the training list
is one clip, so that every batch is the same).  The logged rates
are SloMo's schedule; SCT's ``teacher_forced`` events follow the draws of a
generator seeded with ``--seed``.  The predict CLI then serves each
resulting snapshot, held to ``VideoInpainter.from_checkpoint``.  A vfi_tpu
SloMo snapshot (no discriminator, an Adam state with its schedule's count)
goes to the port's layout and back through
``scripts/convert_checkpoint_torch.py``, bit-identical.  No vfi_tpu
subprocess runs: the data order is fixed (--serial_batches --no_backwards
--no_flip --num_threads 0, clips of exactly K+T+F frames)."""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scripts import convert_checkpoint_torch as converter
from vfi_tpu.train import environments as jenvs
from vfi_tpu.utils import checkpoint as jckpt
from vfi_tpu_torch.api import VideoInpainter
from vfi_tpu_torch.cli import predict as predict_cli
from vfi_tpu_torch.cli import train as train_cli
from vfi_tpu_torch.data.synthetic import make_videolist
from vfi_tpu_torch.models.registry import create_model
from vfi_tpu_torch.nn.vgg import random_vgg16_npz
from vfi_tpu_torch.train.environments import SCTEnvironment, create_training_environment
from vfi_tpu_torch.utils import checkpoint as tckpt
from vfi_tpu_torch.utils.config import TrainConfig
from vfi_tpu_torch.utils.params import random_jax_params
from vfi_tpu_torch.utils.png import read_png
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

HW, B, SEED = 32, 2, 5
LENS = dict(K=2, T=2, F=2, alt_K=3, alt_T=3, alt_F=3)
MODELS = {
    "slomo": dict(c_dim=3, spec={"class": "SloMoFillInModel", "args": [], "kwargs": dict(base_dim=4, c_dim=3)},
                  extra=["--lr", "1e-3", "--lr_decay_count", "2", "--lr_decay_rate", "0.5"],
                  terms=("reconstruction_loss", "perceptual_loss", "warping_loss", "smooth_loss", "G_loss")),
    "sct": dict(c_dim=1, spec={"class": "SCTSkipConScaledTForwardFillInModel", "args": [],
                               "kwargs": dict(c_dim=1, num_blocks=1, num_heads=2, d_v=16, d_ff=32)},
                extra=["--df_dim", "8", "--Ip", "1", "--tf_p_max", "1", "--tf_p_min", "0", "--tf_offset", "1",
                       "--tf_decay", "0.5"],
                terms=("G_Lp", "G_gdl", "G_GAN", "G_loss", "D_fake", "D_real", "teacher_forced")),
}


def _lists(root):
    K, T, F = LENS["K"], LENS["T"], LENS["F"]

    def clips(name, n, frames, seed):
        return make_videolist(os.path.join(root, name), n, seed, n_frames=frames, hw=HW)

    # One clip listed 6 times: a resumed run's loader starts its epoch afresh,
    # and with every batch the same the resumed and the one-run iteration 3 see
    # the same data.
    train = clips("train", 1, K + T + F, 1)
    with open(train) as f:
        line = f.read().strip()
    with open(train, "w") as f:
        f.write("\n".join([line] * 6) + "\n")
    return {"--train_video_list_path": train,
            "--val_video_list_path": clips("val", B, K + T + F, 2),
            "--val_video_list_alt_T_path": clips("alt_T", B, K + LENS["alt_T"] + F, 3),
            "--val_video_list_alt_K_F_path": clips("alt_K_F", B, LENS["alt_K"] + T + LENS["alt_F"], 4)}


def _train_args(root, model, name, max_iter, lists, vgg):
    m = MODELS[model]
    return ["--name", name, "--model_key", json.dumps(m["spec"]), "--c_dim", str(m["c_dim"]), "--image_size",
            str(HW), "--batch_size", str(B), "--seed", str(SEED), "--num_threads", "0", "--serial_batches",
            "--no_backwards", "--no_flip", "--print_freq", "1", "--save_latest_freq", "2", "--validate_freq", "2",
            "--vgg16_weights", vgg, "--device", "cpu", "--max_iter", str(max_iter),
            *(a for k, v in LENS.items() for a in (f"--{k}", str(v))), *(a for kv in lists.items() for a in kv),
            "--checkpoints_dir", os.path.join(root, "ckpt"), "--tensorboard_dir", os.path.join(root, "tb"),
            "--log_json", os.path.join(root, f"{name}.jsonl"), *m["extra"]]


def _events(root, name, kind):
    with open(os.path.join(root, f"{name}.jsonl")) as f:
        return [e for e in map(json.loads, f) if e["event"] == kind]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """For each model: 2 iterations then a resume to 3 (``<model>``), and 3
    iterations in one run (``<model>_ref``)."""
    root = str(tmp_path_factory.mktemp("zoo_cli"))
    lists = _lists(root)
    vgg = random_vgg16_npz(os.path.join(root, "vgg16.npz"), seed=6)
    with pytest.MonkeyPatch.context() as mp:
        # No TensorBoard writer (tests/test_torch_train_cli.py holds the CLI's
        # events): importing it costs ~12 s here, and it adds visualisation forwards.
        mp.setattr(train_cli, "make_writer", lambda log_dir: None)
        for model in MODELS:
            for name, plan in ((model, (2, 3)), (f"{model}_ref", (3,))):
                for max_iter in plan:
                    train_cli.main(_train_args(root, model, name, max_iter, lists, vgg))
    return dict(root=root, lists=lists)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_zoo_train_cli_resumes_where_it_stopped(runs, model):
    root = runs["root"]
    its, ref = _events(root, model, "iter"), _events(root, f"{model}_ref", "iter")
    assert [e["iter"] for e in its] == [e["iter"] for e in ref] == [1, 2, 3]
    assert [e["iter"] for e in _events(root, model, "resume")] == [2]
    for got, want in zip(its, ref):
        for k in MODELS[model]["terms"]:
            assert math.isfinite(got[k]) and abs(got[k] - want[k]) <= 1e-5 * max(abs(want[k]), 1e-6), (got, want)
        assert got["lr"] == want["lr"]
    assert [e["tag"] for e in _events(root, model, "val")] == ["val", "val_alt_T", "val_alt_K_F"]
    names = set(os.listdir(os.path.join(root, "ckpt", model)))
    assert {"model_latest.ckpt", "model_00000002.ckpt", "model_best.ckpt"} <= names
    payload, counters = tckpt.load_snapshot(os.path.join(root, "ckpt", model), "model_latest.ckpt")
    assert payload["step"] == counters["updates"] == 2
    assert ("discriminator" in payload) == (model == "sct") and ("rng" in payload) == (model == "sct")


def test_a_snapshot_loads_only_into_a_state_of_its_kind(runs):
    """SloMo's snapshot has no discriminator, SCT's has one: neither loads
    into the other's training state."""
    states = {}
    for model, extra in (("slomo", {"lambda_p": 0.0}), ("sct", {"df_dim": 8, "Ip": 1})):
        env = create_training_environment(create_model(MODELS[model]["spec"]), TrainConfig(K=2, T=2, F=2, **extra))
        states[model] = env.init_state((HW, HW), device="cpu")
    with pytest.raises(ValueError, match="has no discriminator, the training state has one"):
        tckpt.load_snapshot(os.path.join(runs["root"], "ckpt", "slomo"), "model_latest.ckpt", states["sct"])
    with pytest.raises(ValueError, match="has a discriminator, the training state has none"):
        tckpt.load_snapshot(os.path.join(runs["root"], "ckpt", "sct"), "model_latest.ckpt", states["slomo"])


def test_slomo_train_cli_logs_the_schedules_rate(runs):
    """lr * 0.5 ** (step // 2) at each update's step (0, 1, then 2 after the resume)."""
    assert [e["lr"] for e in _events(runs["root"], "slomo", "iter")] == [1e-3, 1e-3, 5e-4]
    assert all(e["perceptual_loss"] > 0 for e in _events(runs["root"], "slomo", "iter"))


def test_sct_train_cli_teacher_forcing_follows_its_generator(runs):
    """One uniform draw per update from a generator seeded --seed (Forward
    draws no orders), against tf_rate(step); the resumed run goes on with
    the generator saved at 2.  tf_rate falls from 0.88 to 0.12 over the
    three steps, so both branches occur."""
    env = SCTEnvironment(None, TrainConfig(K=2, T=2, F=2, tf_p_max=1.0, tf_p_min=0.0, tf_offset=1.0, tf_decay=0.5))
    g = torch.Generator().manual_seed(SEED)
    want = [float(torch.rand((), generator=g) < env.tf_rate(step)) for step in range(3)]
    got = [e["teacher_forced"] for e in _events(runs["root"], "sct", "iter")]
    assert got == want and set(got) == {0.0, 1.0}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_predict_cli_serves_the_zoo_snapshots(runs, model, capsys):
    root, m = runs["root"], MODELS[model]
    K, T, F = LENS["K"], LENS["T"], LENS["F"]
    qual = os.path.join(root, f"qual_{model}")
    stats = predict_cli.main(["--K", str(K), "--T", str(T), "--F", str(F), "--c_dim", str(m["c_dim"]),
                              "--image_size", str(HW), "--batch_size", str(B), "--model_key", json.dumps(m["spec"]),
                              "--name", model, "--checkpoints_dir", os.path.join(root, "ckpt"),
                              "--snapshot_file_name", "model_latest.ckpt", "--num_threads", "0",
                              "--test_video_list_path", runs["lists"]["--val_video_list_path"],
                              "--qual_result_root", qual, "--device", "cpu", "--device_normalize"])
    assert stats["clips"] == B and "predicted 2 clips" in capsys.readouterr().out
    ip = VideoInpainter.from_checkpoint(json.dumps(m["spec"]), os.path.join(root, "ckpt", model),
                                        "model_latest.ckpt", device="cpu")
    worst = 0
    for i in range(B):
        label = f"clip{i}.npy_1-{K + T + F}"
        assert len(os.listdir(os.path.join(qual, label))) == K + 2 * T + F
        vid = np.load(os.path.join(os.path.dirname(runs["lists"]["--val_video_list_path"]), f"clip{i}.npy"))
        rgb = vid[..., ::-1] if m["c_dim"] == 3 else vid  # the clips are BGR as the loader reads them
        want = ip.inpaint(rgb[:K], rgb[K + T:], T)
        for t in range(T):
            got = read_png(os.path.join(qual, label, f"pred_middle_{K + t:04d}.png"))
            worst = max(worst, int(np.abs(got.astype(np.int16) - want[t].reshape(got.shape)).max()))
    assert worst <= 1


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    return {prefix: np.asarray(tree)}


def test_slomo_snapshot_converts_both_ways_bit_identical(tmp_path):
    """A vfi_tpu SloMo state (random weights, Adam moments, the schedule's
    count; no discriminator) -> the port's layout -> vfi_tpu's, and the
    port's payload back again: every array bit-identical."""
    spec = MODELS["slomo"]["spec"]
    key = json.dumps(spec)
    rng = np.random.RandomState(7)
    g = random_jax_params(spec, seed=8)
    mu, nu = (jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32) ** p, g) for p in (1, 2))
    count = jnp.asarray(3, jnp.int32)
    state = jenvs.TrainState(step=count, g_params=jax.tree.map(jnp.asarray, g),
                             g_opt=(optax.ScaleByAdamState(count=count, mu=mu, nu=nu),
                                    optax.ScaleByScheduleState(count=count)),
                             rng=jax.random.split(jax.random.PRNGKey(0), 3)[2])
    counters = {"updates": 3, "sum_avg_psnr_err": 12.5, "sum_avg_ssim_err": 0.75}
    jckpt.save_snapshot(str(tmp_path / "jax"), "model_latest.ckpt", state, counters)
    converter.main(["to_torch", str(tmp_path / "jax" / "model_latest.ckpt"), str(tmp_path / "torch" / "model.ckpt"),
                    "--model_key", key])
    payload, got_counters = tckpt.load_snapshot(str(tmp_path / "torch"), "model.ckpt")
    assert "discriminator" not in payload and "d_opt" not in payload and payload["step"] == 3
    assert got_counters == counters and all(int(s["step"]) == 3 for s in payload["g_opt"]["state"].values())
    converter.main(["to_jax", str(tmp_path / "torch" / "model.ckpt"), str(tmp_path / "back" / "model.ckpt"),
                    "--model_key", key])
    back, back_counters = converter.read_jax_snapshot(str(tmp_path / "back" / "model.ckpt"))
    want, _ = converter.read_jax_snapshot(str(tmp_path / "jax" / "model_latest.ckpt"))
    assert back["d_params"] is None and back["d_opt"] is None and back["g_opt"]["1"]["count"] == 3
    got_flat, want_flat = _flat(back), _flat(want)
    assert sorted(got_flat) == sorted(want_flat)
    for k in want_flat:
        assert got_flat[k].dtype == want_flat[k].dtype and np.array_equal(got_flat[k], want_flat[k]), k
    again = converter.to_torch_payload(back, back_counters, key)
    for name in ("generator",):
        assert all(torch.equal(again[name][k], payload[name][k]) for k in payload[name])
    for i, s in payload["g_opt"]["state"].items():
        assert all(torch.equal(again["g_opt"]["state"][i][k], s[k]) for k in s)

"""The rest of the bi-MCNet fill-in family in vfi_tpu_torch against vfi_tpu on
the CPU at toy widths: bi-TWA, bi-SA, MC-Net and TW_P_F forwards on the same
weights (f32 max-abs <= 5e-3, uint8 PSNR >= 45 dB, PARITY_r05.md:9-10); one
MCNetEnvironment step and one bi-SA step (loss terms within rel 1e-3,
gradients within global-L2-relative 1e-3, tests/test_grad_parity.py's measure); TAI under
``remat`` against TAI without it and against vfi_tpu's ``remat=True``; and
the parameter-free TW_P_F through ``eval_metrics`` and through the predict
CLI without a snapshot, against vfi_tpu's cli/predict.py."""

import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfi_tpu.models import fill_in as jfill
from vfi_tpu.nn.discriminator import SNDiscriminator as JDisc
from vfi_tpu.train import environments as jenvs
from vfi_tpu.utils.config import TrainConfig as JTrainConfig
from vfi_tpu_torch.cli import predict
from vfi_tpu_torch.data.synthetic import make_videolist
from vfi_tpu_torch.models.registry import create_model
from vfi_tpu_torch.nn import kernelnet, mcnet
from vfi_tpu_torch.train.environments import (MCNetEnvironment, TAIEnvironment, create_eval_environment,
                                              create_training_environment)
from vfi_tpu_torch.utils.config import TrainConfig
from vfi_tpu_torch.utils.params import params_from_jax, random_jax_disc_variables, random_jax_params
from vfi_tpu_torch.utils.png import read_png
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
B, T, H, W = 2, 2, 32, 32


def _spec(cls, c_dim):
    if cls == "TimeWeightedPFFillInModel":
        return {"class": cls, "args": [], "kwargs": {}}
    return {"class": cls, "args": [], "kwargs": dict(gf_dim=8, c_dim=c_dim, feature_size=3)}


def _u8(x):
    return np.round(np.clip((np.asarray(x, np.float64) + 1.0) / 2.0, 0.0, 1.0) * 255.0)


def _global_rel(got: dict, want: dict) -> float:
    assert sorted(got) == sorted(want)
    num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in want)
    den = sum(float((want[k].double() ** 2).sum()) for k in want)
    return (num / den) ** 0.5


@pytest.mark.parametrize("cls,c_dim,K,F", [
    ("BidirectionalTimeWeightedAverageFillInModel", 1, 3, 3),
    ("BidirectionalTimeWeightedAverageFillInModel", 3, 3, 4),  # K != F: two rollouts
    ("BidirectionalSimpleAverageFillInModel", 1, 3, 3),
    ("BidirectionalSimpleAverageFillInModel", 3, 3, 3),
    ("MCNetFillInModel", 1, 3, 3),
    ("MCNetFillInModel", 3, 2, 3),
    ("TimeWeightedPFFillInModel", 1, 3, 3),
    ("TimeWeightedPFFillInModel", 3, 2, 3),
])
def test_forward_matches_vfi_tpu(cls, c_dim, K, F):
    spec = _spec(cls, c_dim)
    jp = random_jax_params(spec, seed=c_dim + K)
    model = create_model(spec)
    model.load_state_dict(params_from_jax(jp))
    model.eval()
    rng = np.random.RandomState(K + F + c_dim)
    p = rng.uniform(-1, 1, (B, K, H, W, c_dim)).astype(np.float32)
    f = rng.uniform(-1, 1, (B, F, H, W, c_dim)).astype(np.float32)
    jmodel = getattr(jfill, cls)(**spec["kwargs"])
    want = jax.jit(lambda prm, a, b: jmodel.apply({"params": prm}, T, a, b))(jp, p, f)
    with torch.no_grad():
        got = model(T, torch.from_numpy(p), torch.from_numpy(f))
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape == (B, T, H, W, c_dim), key
        err = float(np.abs(g - w).max())
        mse = float(np.mean((_u8(g) - _u8(w)) ** 2))
        psnr = 10 * math.log10(255.0**2 / max(mse, 1e-10))
        assert err <= 5e-3 and psnr >= 45.0, (key, err, psnr)


@pytest.mark.parametrize("cls", ["MCNetFillInModel", "BidirectionalSimpleAverageFillInModel"])
def test_training_step_matches_vfi_tpu(cls):
    """One train_step from the same weights and batch: the loss terms and the
    step's G and D gradients (vfi_tpu's read from its Adam first moments)."""
    K, F = 3, 3
    spec = _spec(cls, 1)
    cfg_kw = dict(K=K, T=T, F=F, df_dim=8, Ip=1, disc_window_size=3)
    g_params = random_jax_params(spec, seed=31)
    d_vars = random_jax_disc_variables(TrainConfig(**cfg_kw), H, W, 1, seed=32)
    targets = np.random.RandomState(33).uniform(-1, 1, (B, K + T + F, H, W, 1)).astype(np.float32)

    jenv = jenvs.create_training_environment(getattr(jfill, cls)(**spec["kwargs"]), JTrainConfig(**cfg_kw))
    jenv.discriminator = JDisc(window_size=3, df_dim=8, Ip=1)
    gp, dp, dsn = (jax.tree.map(jnp.asarray, t) for t in (g_params, d_vars["params"], d_vars["sn"]))
    jstate = jenvs.TrainState(step=jnp.zeros((), jnp.int32), g_params=gp, g_opt=jax.jit(jenv.g_tx().init)(gp),
                              d_params=dp, d_sn=dsn, d_opt=jax.jit(jenv.d_tx().init)(dp), rng=jax.random.PRNGKey(0))
    jstate, want = jenv.train_step(jstate, K, T, F, targets)
    b1 = jenv.cfg.beta1
    g_grad = params_from_jax(jax.tree.map(lambda m: np.asarray(m) / (1 - b1), jstate.g_opt[0].mu))
    d_grad = params_from_jax(jax.tree.map(lambda m: np.asarray(m) / (1 - b1), jstate.d_opt[0].mu))

    env = create_training_environment(create_model(spec), TrainConfig(**cfg_kw))
    assert type(env) is {"MCNetFillInModel": MCNetEnvironment,
                         "BidirectionalSimpleAverageFillInModel": TAIEnvironment}[cls]
    assert type(env).__name__ == type(jenv).__name__ and (env.min_K, env.min_F) == (jenv.min_K, jenv.min_F)
    state = env.init_state((H, W), g_params=g_params, d_variables=d_vars, device="cpu")
    state, got = env.train_step(state, K, T, F, targets)
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-3 * abs(float(want[k])), (k, float(got[k]), float(want[k]))
    assert _global_rel({n: p.grad for n, p in state.generator.named_parameters()}, g_grad) <= 1e-3
    assert _global_rel({n: p.grad for n, p in state.discriminator.named_parameters()}, d_grad) <= 1e-3


TAI_TOY = {"class": "TAIFillInModel", "args": [],
           "kwargs": dict(gf_dim=8, c_dim=1, feature_size=3, ks=5, num_block=5, kf_dim=4, layers=3)}


def _count_calls(monkeypatch, owner, name):
    """Record a call of ``owner.name`` in the returned list each time it runs."""
    calls = []
    real = getattr(owner, name)

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(owner, name, counted)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_keeps_the_gradient_and_the_sepconv_calls(dtype, monkeypatch):
    """TAI's G-loss gradient through TAIEnvironment (the generator run on
    cast copies of its masters) with and without remat: equal within
    global-L2-relative 1e-6, with the same sepconv calls (KernelNet is not
    checkpointed), while the checkpointed MotionEnc runs again in the backward."""
    K, F = 3, 3
    g_params = random_jax_params(TAI_TOY, seed=41)
    targets = torch.from_numpy(np.random.RandomState(42).uniform(-1, 1, (B, K + T + F, H, W, 1)).astype(np.float32))
    sep = _count_calls(monkeypatch, kernelnet, "sepconv")
    motion = _count_calls(monkeypatch, mcnet.MotionEnc, "forward")
    grads, counts = {}, {}
    for remat in (False, True):
        model = create_model(TAI_TOY)
        model.mcnet.remat = remat
        env = create_training_environment(model, TrainConfig(K=K, T=T, F=F, df_dim=8, Ip=1, train_dtype=dtype))
        state = env.init_state((H, W), g_params=g_params, device="cpu", seed=1)
        sep.clear()
        motion.clear()
        loss, _ = env._g_loss(state, K, T, F, targets)
        n_forward = (len(sep), len(motion))
        params = list(state.generator.parameters())
        grads[remat] = dict(zip([n for n, _ in state.generator.named_parameters()],
                                torch.autograd.grad(loss, params, allow_unused=True)))
        counts[remat] = (n_forward, len(sep), len(motion))
    grads = {r: {n: g for n, g in gr.items() if g is not None} for r, gr in grads.items()}
    assert _global_rel(grads[True], grads[False]) <= 1e-6
    (fwd_sep, fwd_motion), sep_total, motion_total = counts[True]
    assert sep_total == fwd_sep == counts[False][1] == counts[False][0][0] == 2
    assert fwd_motion == counts[False][2] == T and motion_total == 2 * T  # recomputed in the backward


def test_remat_gradient_matches_vfi_tpu_remat():
    """The port's TAI under remat against vfi_tpu's TAIFillInModel(remat=True):
    the gradient of the mean squared outputs, global-L2-relative 1e-3."""
    K, F = 3, 3
    jp = random_jax_params(TAI_TOY, seed=43)
    rng = np.random.RandomState(44)
    p = rng.uniform(-1, 1, (B, K, H, W, 1)).astype(np.float32)
    f = rng.uniform(-1, 1, (B, F, H, W, 1)).astype(np.float32)
    jmodel = jfill.TAIFillInModel(**TAI_TOY["kwargs"], remat=True)

    def jloss(prm):
        out = jmodel.apply({"params": prm}, T, p, f)
        return sum(jnp.mean(out[k] ** 2) for k in sorted(out))

    want = params_from_jax(jax.jit(jax.grad(jloss))(jp))
    model = create_model({**TAI_TOY, "kwargs": {**TAI_TOY["kwargs"], "remat": True, "scan_rollout": True}})
    assert model.mcnet.remat
    model.load_state_dict(params_from_jax(jp))
    out = model(T, torch.from_numpy(p), torch.from_numpy(f))
    loss = sum(torch.mean(out[k] ** 2) for k in sorted(out))
    named = dict(model.named_parameters())
    got = dict(zip(named, torch.autograd.grad(loss, list(named.values()), allow_unused=True)))
    got = {n: torch.zeros_like(named[n]) if g is None else g for n, g in got.items()}
    assert _global_rel(got, want) <= 1e-3


def test_time_weighted_pf_eval_metrics_match_vfi_tpu():
    """A model without parameters through eval_metrics (the device from the
    inputs); vfi_tpu scores it with empty params."""
    K, F = 2, 2
    targets = np.random.RandomState(45).uniform(-1, 1, (B, K + T + F, H, W, 1)).astype(np.float32)
    jenv = jenvs.create_eval_environment(jfill.TimeWeightedPFFillInModel(), JTrainConfig(K=K, T=T, F=F))
    want = {k: np.asarray(v) for k, v in jenv.eval_metrics({}, K, T, F, jnp.asarray(targets)).items()}
    env = create_eval_environment(create_model("TimeWeightedPFFillInModel"), TrainConfig(K=K, T=T, F=F))
    assert not env.needs_snapshot and not jenv.needs_snapshot
    for targets_in in (targets, torch.from_numpy(targets)):
        got = {k: v.numpy() for k, v in env.eval_metrics(K, T, F, targets_in).items()}
        np.testing.assert_allclose(got["psnr"], want["psnr"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(got["ssim"], want["ssim"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(got["l2"], want["l2"], rtol=1e-5, atol=0)


def test_time_weighted_pf_predict_matches_vfi_tpu(tmp_path):
    """TW_P_F served by the predict CLI without a snapshot, as vfi_tpu's
    cli/predict.py serves it: the same PNG files, pixels within 1 uint8 level."""
    K = F = 2
    videolist = make_videolist(str(tmp_path / "clips"), 3, seed=46, n_frames=K + T + F, hw=H)
    args = ["--K", str(K), "--T", str(T), "--F", str(F), "--c_dim", "1", "--image_size", str(H), "--batch_size", "2",
            "--model_key", "TimeWeightedPFFillInModel", "--test_video_list_path", videolist, "--num_threads", "0",
            "--checkpoints_dir", str(tmp_path / "no_snapshots")]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO, "XLA_FLAGS": ""}
    r = subprocess.run([sys.executable, os.path.join(REPO, "cli", "predict.py"), *args, "--qual_result_root",
                        str(tmp_path / "jax")], cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    stats = predict.main(args + ["--qual_result_root", str(tmp_path / "torch"), "--device", "cpu"])
    assert stats["clips"] == 3 and not os.path.exists(tmp_path / "no_snapshots")
    clips = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "torch")) == clips and len(clips) == 3
    worst = 0
    for clip in clips:
        names = sorted(os.listdir(tmp_path / "jax" / clip))
        assert sorted(os.listdir(tmp_path / "torch" / clip)) == names and len(names) == K + 2 * T + F
        for name in names:
            a, b = (read_png(str(tmp_path / side / clip / name)).astype(np.int16) for side in ("torch", "jax"))
            worst = max(worst, int(np.abs(a - b).max()))
    assert worst <= 1

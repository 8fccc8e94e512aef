"""Super SloMo in vfi_tpu_torch against vfi_tpu on the CPU at a toy width
(base_dim 4, 32x32): the forward in gray and color and in both warp modes;
two SloMoEnvironment steps across a learning-rate decay boundary, with the
perceptual term on a seeded VGG16 .npz (loss terms, the step-1 gradient, the
updates); the refusal to train lambda_p > 0 without VGG16 weights; the
environment's state, sampling and mixed precision; and the goldens that
chip_smoke.py holds the card against."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from vfi_tpu.models.slomo import SloMoFillInModel as JSloMo
from vfi_tpu.train import environments as jenvs
from vfi_tpu.utils.config import TrainConfig as JTrainConfig
from vfi_tpu_torch.models.registry import create_model
from vfi_tpu_torch.nn.vgg import random_vgg16_npz
from vfi_tpu_torch.train.environments import TrainState, create_training_environment
from vfi_tpu_torch.train import slomo_env
from vfi_tpu_torch.train.slomo_env import SloMoEnvironment
from vfi_tpu_torch.utils.config import TrainConfig
from vfi_tpu_torch.utils.params import params_from_jax, random_jax_params
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

B, K, T, F, H, W = 2, 2, 3, 2, 32, 32
TERMS = ("reconstruction_loss", "perceptual_loss", "warping_loss", "smooth_loss", "G_loss")


def _spec(c_dim, mode="pixel"):
    return {"class": "SloMoFillInModel", "args": [], "kwargs": dict(base_dim=4, c_dim=c_dim, warp_mode=mode)}


def _global_rel(got: dict, want: dict) -> float:
    assert sorted(got) == sorted(want)
    num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in want)
    den = sum(float((want[k].double() ** 2).sum()) for k in want)
    return (num / den) ** 0.5


@pytest.mark.parametrize("c_dim,mode", [(1, "pixel"), (3, "pixel"), (3, "torch03")])
def test_slomo_forward_matches_jax(c_dim, mode):
    spec = _spec(c_dim, mode)
    jp = random_jax_params(spec, seed=c_dim)
    model = create_model(spec)
    model.load_state_dict(params_from_jax(jp))
    model.eval()
    rng = np.random.RandomState(10 + c_dim)
    p = rng.uniform(-1, 1, (B, K, H, W, c_dim)).astype(np.float32)
    f = rng.uniform(-1, 1, (B, F, H, W, c_dim)).astype(np.float32)
    want = jax.jit(lambda prm, a, b: JSloMo(**spec["kwargs"]).apply({"params": prm}, T, a, b))(jp, p, f)
    with torch.no_grad():
        got = model(T, torch.from_numpy(p), torch.from_numpy(f))
    assert sorted(got) == sorted(want) == sorted(chip_smoke.SLOMO_KEYS)
    assert tuple(got["pred"].shape) == (B, T, H, W, c_dim) and tuple(got["F_0_1"].shape) == (B, H, W, 2)
    for key in chip_smoke.SLOMO_KEYS:
        assert float(np.abs(got[key].numpy() - np.asarray(want[key])).max()) <= 5e-3, key
    pred = np.asarray(want["pred"])
    assert chip_smoke.u8_psnr(chip_smoke.u8(got["pred"].numpy()), chip_smoke.u8(pred)) >= 45.0
    assert pred.std() > 0.1


@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    return random_vgg16_npz(str(tmp_path_factory.mktemp("vgg") / "vgg16.npz"), seed=3)


@pytest.fixture(scope="module")
def two_steps(vgg_npz):
    """Both packages from the same weights and batch: two steps, the second
    after the decay boundary (lr_decay_count=1).  JAX's gradients are read
    from its Adam first moments (b1 = 0.5): g1 = mu1 / (1 - b1), g2 = (mu2 -
    b1 mu1) / (1 - b1).  The port runs twice: on its own gradients, and with
    ``.grad`` set to JAX's before each of its Adam steps, so the updates are
    held to vfi_tpu's given the same gradients (on its own, Adam's first
    steps turn the f32 noise of this toy's near-zero gradients, ~1e-7 deep in
    the refinement UNet, into sign flips of whole updates)."""
    spec = _spec(3)
    cfg_kw = dict(K=K, T=T, F=F, lr=1e-3, lr_decay_count=1, lr_decay_rate=0.5, vgg16_weights=vgg_npz)
    g_params = random_jax_params(spec, seed=5)
    targets = np.random.RandomState(6).uniform(-1, 1, (B, K + T + F, H, W, 3)).astype(np.float32)

    jenv = jenvs.create_training_environment(JSloMo(**spec["kwargs"]), JTrainConfig(**cfg_kw))
    gp = jax.tree.map(jnp.asarray, g_params)
    jstate = jenvs.TrainState(step=jnp.zeros((), jnp.int32), g_params=gp, g_opt=jax.jit(jenv.g_tx().init)(gp),
                              rng=jax.random.PRNGKey(0))
    b1 = jenv.cfg.beta1
    want_terms, mus = [], []
    for i in range(2):
        jstate, m = jenv.train_step(jstate, K, T, F, targets)
        want_terms.append({k: float(v) for k, v in m.items()})
        mus.append(params_from_jax(jstate.g_opt[0].mu))
    grads = [{k: mus[0][k] / (1.0 - b1) for k in mus[0]},
             {k: (mus[1][k] - b1 * mus[0][k]) / (1.0 - b1) for k in mus[0]}]

    def port_run(fed):
        env = create_training_environment(create_model(spec), TrainConfig(**cfg_kw))
        state = env.init_state((H, W), g_params=g_params, device="cpu")
        terms, lrs, grad1 = [], [], None
        queue = list(grads)

        def set_jax_grads(module, loss, group):
            g = queue.pop(0)
            for n, p in module.named_parameters():
                p.grad = g[n].clone()

        with pytest.MonkeyPatch.context() as mp:
            if fed:
                mp.setattr(slomo_env, "_set_grads", set_jax_grads)
            for i in range(2):
                state, m = env.train_step(state, K, T, F, targets)
                terms.append({k: float(v) for k, v in m.items()})
                lrs.append(state.g_opt.param_groups[0]["lr"])
                if i == 0:
                    grad1 = {n: p.grad.clone() for n, p in state.generator.named_parameters()}
        return terms, lrs, grad1, {n: p.detach() for n, p in state.generator.named_parameters()}

    got_terms, lrs, got_grad1, _ = port_run(fed=False)
    _, fed_lrs, _, fed_params = port_run(fed=True)
    return dict(start=params_from_jax(g_params), want_terms=want_terms, got_terms=got_terms, grad1=grads[0],
                got_grad1=got_grad1, want_params=params_from_jax(jstate.g_params), fed_params=fed_params,
                lrs=lrs, fed_lrs=fed_lrs)


def test_slomo_train_step_terms_match_jax(two_steps):
    for got, want in zip(two_steps["got_terms"], two_steps["want_terms"]):
        assert sorted(got) == sorted(want) == sorted(TERMS)
        for k in TERMS:
            assert abs(got[k] - want[k]) <= 1e-3 * abs(want[k]), (k, got[k], want[k])
    assert two_steps["want_terms"][0]["perceptual_loss"] > 0


def test_slomo_train_step_gradient_and_updates_match_jax(two_steps):
    assert _global_rel(two_steps["got_grad1"], two_steps["grad1"]) <= 1e-3
    start, got, want = two_steps["start"], two_steps["fed_params"], two_steps["want_params"]
    assert _global_rel({k: got[k] - start[k] for k in want}, {k: want[k] - start[k] for k in want}) <= 1e-3
    # the rate of each update, lr * 0.5 ** (step // 1), as optax's schedule reads it
    assert two_steps["lrs"] == two_steps["fed_lrs"] == [1e-3, 5e-4]


def test_slomo_needs_vgg16_weights_for_the_perceptual_term():
    """As in vfi_tpu: lambda_p > 0 without weights raises; lambda_p = 0 trains
    with the perceptual term at exactly 0."""
    with pytest.raises(RuntimeError, match="vgg16_weights"):
        create_training_environment(create_model(_spec(1)), TrainConfig(K=K, T=T, F=F))
    with pytest.raises(RuntimeError, match="vgg16_weights"):
        jenvs.create_training_environment(JSloMo(base_dim=4, c_dim=1), JTrainConfig(K=K, T=T, F=F))
    env = create_training_environment(create_model(_spec(1)), TrainConfig(K=K, T=T, F=F, lambda_p=0.0))
    state = env.init_state((H, W), device="cpu")
    targets = np.random.RandomState(7).uniform(-1, 1, (1, K + T + F, H, W, 1)).astype(np.float32)
    _, terms = env.train_step(state, K, T, F, targets)
    assert float(terms["perceptual_loss"]) == 0.0 and np.isfinite(float(terms["G_loss"]))


def test_slomo_environment_state_sampling_and_device(monkeypatch):
    env = create_training_environment(create_model(_spec(1)), TrainConfig(K=4, T=3, F=4, lambda_p=0.0))
    assert isinstance(env, SloMoEnvironment)
    rng = np.random.RandomState(0)
    draws = [env.sample_ktf(rng, True) for _ in range(200)]
    assert {d[0] for d in draws} == {1, 2, 3, 4} and {d[1] for d in draws} == {1, 2, 3}
    assert {d[2] for d in draws} == {1, 2, 3, 4}
    assert env.sample_ktf(rng, False) == (4, 3, 4)
    state = env.init_state((H, W), device="cpu", seed=3)
    assert isinstance(state, TrainState) and state.discriminator is None and state.d_opt is None
    assert state.rng is None and state.step == 0 and state.device.type == "cpu"
    assert [env.learning_rate(s) for s in (0, 39999, 40000, 80000)] == [1e-4, 1e-4, 1e-4 * 0.1, 1e-4 * 0.1 ** 2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        env.init_state((H, W))


def test_slomo_mixed_precision_step(vgg_npz):
    """bf16: the generator and VGG16 on bf16 copies, losses in f32, the f32
    masters updated; the terms near the f32 step's."""
    spec = _spec(3)
    g_params = random_jax_params(spec, seed=8)
    targets = np.random.RandomState(9).uniform(-1, 1, (B, K + T + F, H, W, 3)).astype(np.float32)
    terms = {}
    for dtype in ("float32", "bfloat16"):
        env = create_training_environment(create_model(spec), TrainConfig(K=K, T=T, F=F, vgg16_weights=vgg_npz,
                                                                          train_dtype=dtype))
        state = env.init_state((H, W), g_params=g_params, device="cpu")
        state, m = env.train_step(state, K, T, F, targets)
        terms[dtype] = {k: float(v) for k, v in m.items()}
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in state.generator.parameters())
    for k in TERMS:
        assert abs(terms["bfloat16"][k] - terms["float32"][k]) <= 0.05 * abs(terms["float32"][k]), k


def test_slomo_golden_fixtures_match_chip_smoke():
    z = np.load(chip_smoke.SLOMO_GOLDEN_PATH)
    cfg = chip_smoke.SLOMO_GOLDEN
    assert {k: z[k].item() for k in cfg} == cfg
    for mode in chip_smoke.WARP_MODES:
        for key in chip_smoke.SLOMO_KEYS:
            assert z[f"{mode}/{key}_at_points"].shape == (cfg["n_points"],)
        assert z[f"{mode}/pred_u8_at_points"].shape == (cfg["n_u8_points"],)
        assert z[f"{mode}/pred_u8_at_points"].std() > 10
    assert os.path.getsize(chip_smoke.SLOMO_GOLDEN_PATH) < 2e6
    t = np.load(chip_smoke.SLOMO_TRAIN_GOLDEN_PATH)
    cfg = chip_smoke.SLOMO_TRAIN_GOLDEN
    assert {k: t[k].item() for k in cfg} == cfg
    assert tuple(t["term_names"]) == chip_smoke.SLOMO_TERM_NAMES and t["terms"].shape == (2, 5)
    assert np.isfinite(t["terms"]).all() and t["terms"][:, 1].min() > 0  # the perceptual term is on
    keys = list(params_from_jax(random_jax_params(cfg["model_key"], 0)))
    assert list(t["g_keys"]) == keys and t["g_proj"].shape == (len(keys),) and np.isfinite(t["g_proj"]).all()
    assert os.path.getsize(chip_smoke.SLOMO_TRAIN_GOLDEN_PATH) < 64e3


@pytest.mark.slow
def test_full_width_slomo_matches_goldens(tmp_path):
    """The port on the CPU at SloMoFillInModel_color's full width against both SloMo goldens."""
    reports = chip_smoke.check_slomo_golden(torch.device("cpu"))
    assert all(r["ok"] for r in reports.values()), reports
    report = chip_smoke.check_slomo_train_golden(torch.device("cpu"), str(tmp_path / "vgg16.npz"))
    assert report["ok"], report

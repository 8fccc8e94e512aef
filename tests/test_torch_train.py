"""vfi_tpu_torch.train against vfi_tpu.train on the CPU at toy widths: one G
update and one D update (loss terms, gradients, SN state), two further full
steps (Adam, the SN updates), bf16 mixed precision, the environment's
dispatch and device rule, and the training golden that chip_smoke.py holds
the card against."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from vfi_tpu.models.fill_in import TAIFillInModel as JTAI
from vfi_tpu.nn.discriminator import SNDiscriminator as JDisc
from vfi_tpu.train import environments as jenvs
from vfi_tpu.utils.config import TrainConfig as JTrainConfig
from vfi_tpu_torch.models.registry import create_model
from vfi_tpu_torch.train.environments import TrainState, create_training_environment
from vfi_tpu_torch.utils.config import TrainConfig
from vfi_tpu_torch.utils.params import disc_variables_from_jax, params_from_jax, random_jax_disc_variables, random_jax_params
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

B, K, T, F, H, W = 2, 3, 2, 3, 32, 32
TOY = dict(gf_dim=8, feature_size=3, ks=5, kf_dim=4, layers=3)
MODELS = {"gray": (1, 5, 3), "color": (3, 4, 1)}  # c_dim, num_block, Ip: TAI_gray-like / TAI_color-like


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _global_rel(got: dict, want: dict) -> float:
    """Global-L2-relative error over every leaf (tests/test_grad_parity.py's measure)."""
    assert sorted(got) == sorted(want)
    num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in want)
    den = sum(float((want[k].double() ** 2).sum()) for k in want)
    return (num / den) ** 0.5


def _setup(c_dim, num_block, Ip, dtype):
    spec = {"class": "TAIFillInModel", "kwargs": dict(TOY, c_dim=c_dim, num_block=num_block)}
    cfg_kw = dict(K=K, T=T, F=F, df_dim=8, Ip=Ip, disc_window_size=3, train_dtype=dtype)
    g_params = random_jax_params(spec, seed=10 + c_dim)
    d_vars = random_jax_disc_variables(TrainConfig(**cfg_kw), H, W, c_dim, seed=20 + c_dim)
    targets = np.random.RandomState(30 + c_dim).uniform(-1, 1, (B, K + T + F, H, W, c_dim)).astype(np.float32)

    jenv = jenvs.create_training_environment(JTAI(**spec["kwargs"]), JTrainConfig(**cfg_kw))
    jenv.discriminator = JDisc(window_size=3, df_dim=8, Ip=Ip)
    gp, dp, dsn = (jax.tree.map(jnp.asarray, t) for t in (g_params, d_vars["params"], d_vars["sn"]))
    # Adam's zero moments in one compiled program, not one per parameter shape.
    jstate = jenvs.TrainState(step=jnp.zeros((), jnp.int32), g_params=gp, g_opt=jax.jit(jenv.g_tx().init)(gp),
                              d_params=dp, d_sn=dsn, d_opt=jax.jit(jenv.d_tx().init)(dp), rng=jax.random.PRNGKey(0))

    env = create_training_environment(create_model(spec), TrainConfig(**cfg_kw))
    state = env.init_state((H, W), g_params=g_params, d_variables=d_vars, device="cpu")
    return jenv, jstate, env, state, targets


def _first_moment_gradient(opt_state, b1):
    """The gradient of an Adam state's first step: mu = (1 - b1) * grad exactly
    (b1 = 0.5), so the JAX step's own gradient, without a second compile."""
    return jax.tree.map(lambda m: np.asarray(m) / (1.0 - b1), opt_state[0].mu)


@pytest.fixture(scope="module", params=sorted(MODELS))
def f32_run(request):
    """Both packages from the same weights and batch, three train_steps each;
    JAX's step-1 gradients are read from its Adam moments and its SN state
    after step 1."""
    jenv, jstate, env, state, targets = _setup(*MODELS[request.param], "float32")
    want_steps = []
    for i in range(3):
        jstate, m = jenv.train_step(jstate, K, T, F, targets)
        want_steps.append({k: float(v) for k, v in m.items()})
        if i == 0:
            b1 = jenv.cfg.beta1
            g_grads, d_grads = (_first_moment_gradient(o, b1) for o in (jstate.g_opt, jstate.d_opt))
            d_sn = jax.tree.map(np.asarray, jstate.d_sn)

    got_steps, grads = [], None
    for i in range(3):
        state, m = env.train_step(state, K, T, F, targets)
        got_steps.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = ({n: p.grad.clone() for n, p in state.generator.named_parameters()},
                     {n: p.grad.clone() for n, p in state.discriminator.named_parameters()},
                     {k: b.clone() for k, b in state.discriminator.state_dict().items() if k.endswith(".u")})
    return dict(terms1=want_steps[0], g_grads=params_from_jax(g_grads),
                d_grads=disc_variables_from_jax({"params": d_grads}),
                u1=disc_variables_from_jax({"params": {}, "sn": d_sn}), want_steps=want_steps,
                got_steps=got_steps, got_grads=grads, state=state)


def test_first_update_loss_terms_match_jax(f32_run):
    got, want = f32_run["got_steps"][0], f32_run["terms1"]
    assert sorted(got) == sorted(want) == sorted([
        "G_Lp", "G_gdl", "G_GAN", "G_Lp_forward", "G_Lp_backward", "G_gdl_forward", "G_gdl_backward", "G_loss",
        "D_fake", "D_real"])
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-5, (k, got[k], want[k])


def test_first_update_generator_gradient_matches_jax(f32_run):
    err = _global_rel(f32_run["got_grads"][0], f32_run["g_grads"])
    assert err <= 1e-4, err


def test_first_update_discriminator_gradient_matches_jax(f32_run):
    err = _global_rel(f32_run["got_grads"][1], f32_run["d_grads"])
    assert err <= 1e-4, err


def test_first_update_sn_state_matches_jax(f32_run):
    got, want = f32_run["got_grads"][2], f32_run["u1"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, rtol=0, err_msg=k)


def test_steps_two_and_three_match_jax(f32_run):
    """Adam(b1=0.5, b2=0.999) and the two SN writes per D step carry across."""
    for step in (0, 1, 2):
        got, want = f32_run["got_steps"][step], f32_run["want_steps"][step]
        tol = 1e-5 if step == 0 else 1e-4
        for k in want:
            assert _rel(got[k], want[k]) <= tol, (step + 1, k, got[k], want[k])
    assert f32_run["state"].step == 3


def test_mixed_precision_step_matches_jax_bf16():
    """bf16 compute over f32 masters on both sides.  bf16 rounds at other
    places in the two frameworks (conv accumulation, bias adds), and the D
    terms are bf16 numbers near 0.7, whose ulp is 5.6e-3 relative.  The
    largest difference measured here is 6.1e-3 (D_real, step 1; the G terms
    at most 1.2e-3), so the gate is 2e-2, about three bf16 ulps."""
    jenv, jstate, env, state, targets = _setup(1, 5, 3, "bfloat16")
    for step in range(2):
        jstate, want = jenv.train_step(jstate, K, T, F, targets)
        state, got = env.train_step(state, K, T, F, targets)
        for k in want:
            assert got[k].dtype == torch.float32
            assert _rel(got[k], want[k]) <= 2e-2, (step + 1, k, float(got[k]), float(want[k]))
    for module, opt in ((state.generator, state.g_opt), (state.discriminator, state.d_opt)):
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in module.parameters())
        for s in opt.state.values():
            assert s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32
    assert all(b.dtype == torch.float32 for b in state.discriminator.buffers())


def test_environment_dispatch_sampling_and_device(monkeypatch):
    spec = {"class": "TWIFillInModel", "kwargs": dict(TOY, c_dim=1, num_block=5)}
    cfg = TrainConfig(K=4, T=3, F=4, df_dim=8, Ip=1)
    env = create_training_environment(create_model(spec), cfg)
    assert type(env).__name__ == "TAIEnvironment"
    rng = np.random.RandomState(0)
    for _ in range(20):
        k, t, f = env.sample_ktf(rng, True)
        assert 2 <= k <= 4 and 1 <= t <= 3 and 2 <= f <= 4
    assert env.sample_ktf(rng, False) == (4, 3, 4)
    with pytest.raises(TypeError, match="no training environment"):
        create_training_environment(torch.nn.Linear(2, 2), cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        env.init_state((32, 32))
    state = env.init_state((32, 32), device="cpu", seed=1)
    assert isinstance(state, TrainState) and state.device.type == "cpu" and state.step == 0


def test_train_golden_fixture_matches_chip_smoke():
    z = np.load(chip_smoke.TRAIN_GOLDEN_PATH)
    cfg = chip_smoke.TRAIN_GOLDEN
    assert {k: z[k].item() for k in cfg} == cfg
    n_terms = len(z["term_names"])
    assert n_terms == 10 and z["terms"].shape == (2, n_terms) and np.isfinite(z["terms"]).all()
    *_, r_g, r_d = chip_smoke.train_golden_setup()
    assert list(z["g_keys"]) == list(r_g) and list(z["d_keys"]) == list(r_d)
    assert z["g_proj"].shape == (len(r_g),) and z["d_proj"].shape == (len(r_d),)
    assert np.isfinite(z["g_proj"]).all() and np.isfinite(z["d_proj"]).all()
    assert os.path.getsize(chip_smoke.TRAIN_GOLDEN_PATH) < 64e3


@pytest.mark.slow
def test_full_width_train_steps_match_golden():
    """The port on the CPU at full TAI_gray width (B=2, f32) against the JAX golden."""
    report = chip_smoke.check_train_golden(torch.device("cpu"))[0]
    assert report["ok"], report

"""Snapshots of the port (vfi_tpu_torch/utils/checkpoint.py) and their
exchange with vfi_tpu's orbax snapshots (scripts/convert_checkpoint_torch.py)
on the CPU, at a toy TAI width.

vfi_tpu takes two training steps from random weights and saves its state;
the snapshot goes to the port's layout and back, bit-exact on every array
(the rng, which the port does not hold, comes back as init_state's).  The
port resumes from the converted snapshot and takes the third step, which is
held to vfi_tpu's third step: loss terms within rel 1e-4, G and D gradients
within global-L2-relative 1e-4 (tests/test_torch_train.py's gates; gradients
are gated globally, not per leaf, as the repo's gradient-parity tests are),
and the state after it (weights, the step's update, both Adam moments, the
step counts) held to vfi_tpu's under the same global gate.
JAX's step-3 gradients are read from its Adam first moments,
grad3 = (mu3 - b1 * mu2) / (1 - b1), so the JAX step compiles once."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts.convert_checkpoint_torch import read_jax_snapshot, to_jax_state, to_torch_payload
from vfi_tpu.models.fill_in import TAIFillInModel as JTAI
from vfi_tpu.nn.discriminator import SNDiscriminator as JDisc
from vfi_tpu.train import environments as jenvs
from vfi_tpu.utils import checkpoint as jckpt
from vfi_tpu.utils.config import TrainConfig as JTrainConfig
from vfi_tpu_torch.models.registry import create_model
from vfi_tpu_torch.train.environments import create_training_environment
from vfi_tpu_torch.utils import checkpoint as tckpt
from vfi_tpu_torch.utils.config import TrainConfig
from vfi_tpu_torch.utils.params import (adam_state_from_jax, adam_state_to_jax, disc_variables_from_jax,
                                        disc_variables_to_jax, params_from_jax, params_to_jax,
                                        random_jax_disc_variables, random_jax_params)
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

B, K, T, F, H, W = 2, 3, 2, 3, 32, 32
SPEC = {"class": "TAIFillInModel", "args": [],
        "kwargs": dict(gf_dim=8, c_dim=1, feature_size=3, ks=5, num_block=5, kf_dim=4, layers=3)}
CFG = dict(K=K, T=T, F=F, df_dim=8, Ip=3, disc_window_size=3)
COUNTERS = {"updates": 2, "sum_avg_psnr_err": 31.25, "sum_avg_ssim_err": 0.875}


def _global_rel(got: dict, want: dict) -> float:
    assert sorted(got) == sorted(want)
    num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in want)
    den = sum(float((want[k].double() ** 2).sum()) for k in want)
    return (num / den) ** 0.5


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """vfi_tpu: two steps, a snapshot, a third step; the third step's terms and gradients."""
    root = str(tmp_path_factory.mktemp("ckpt"))
    g_params = random_jax_params(SPEC, 40)
    d_vars = random_jax_disc_variables(TrainConfig(**CFG), H, W, 1, 41)
    targets = np.random.RandomState(42).uniform(-1, 1, (B, K + T + F, H, W, 1)).astype(np.float32)
    jenv = jenvs.create_training_environment(JTAI(**SPEC["kwargs"]), JTrainConfig(**CFG))
    jenv.discriminator = JDisc(window_size=3, df_dim=8, Ip=3)
    gp, dp, dsn = (jax.tree.map(jnp.asarray, t) for t in (g_params, d_vars["params"], d_vars["sn"]))
    state = jenvs.TrainState(step=jnp.zeros((), jnp.int32), g_params=gp, g_opt=jax.jit(jenv.g_tx().init)(gp),
                             d_params=dp, d_sn=dsn, d_opt=jax.jit(jenv.d_tx().init)(dp),
                             rng=jax.random.split(jax.random.PRNGKey(0), 3)[2])
    for _ in range(2):
        state, _ = jenv.train_step(state, K, T, F, targets)
    jckpt.save_snapshot(os.path.join(root, "jax"), "model_latest.ckpt", state, COUNTERS)
    mu2 = jax.tree.map(np.asarray, (state.g_opt[0].mu, state.d_opt[0].mu))  # train_step donates its state
    state, terms3 = jenv.train_step(state, K, T, F, targets)
    b1 = jenv.cfg.beta1

    def grad3(mu3, mu2):
        return jax.tree.map(lambda a, b: (np.asarray(a) - b1 * np.asarray(b)) / (1.0 - b1), mu3, mu2)

    g_adam, d_adam = state.g_opt[0], state.d_opt[0]
    return dict(root=root, targets=targets, terms3={k: float(v) for k, v in terms3.items()},
                g_grad3=params_from_jax(grad3(g_adam.mu, mu2[0])),
                d_grad3=disc_variables_from_jax({"params": grad3(d_adam.mu, mu2[1])}),
                # vfi_tpu's state after step 3, in the port's names and layouts
                count3=(int(g_adam.count), int(d_adam.count)),
                generator3=params_from_jax(state.g_params),
                discriminator3=disc_variables_from_jax({"params": state.d_params, "sn": state.d_sn}),
                g_moments3=(params_from_jax(g_adam.mu), params_from_jax(g_adam.nu)),
                d_moments3=tuple(disc_variables_from_jax({"params": m}) for m in (d_adam.mu, d_adam.nu)))


def test_snapshot_round_trip_in_the_port(tmp_path):
    """save_snapshot / load_snapshot restore modules, Adam states, step and counters exactly."""
    env = create_training_environment(create_model(SPEC), TrainConfig(**CFG))
    state = env.init_state((H, W), g_params=random_jax_params(SPEC, 1), device="cpu", seed=2)
    torch.manual_seed(3)
    for opt, module in ((state.g_opt, state.generator), (state.d_opt, state.discriminator)):
        for p in module.parameters():  # one Adam step on random gradients fills its state
            p.grad = torch.randn_like(p)
        opt.step()
    state.step = 1
    assert not tckpt.has_snapshot(str(tmp_path), "model_00000001.ckpt")
    tckpt.save_snapshot(str(tmp_path), "model_00000001.ckpt", state, COUNTERS)
    assert tckpt.has_snapshot(str(tmp_path), "model_00000001.ckpt")
    assert os.path.isdir(tmp_path / "model_00000001.ckpt")

    fresh = env.init_state((H, W), device="cpu", seed=5)
    got, counters = tckpt.load_snapshot(str(tmp_path), "model_00000001.ckpt", fresh)
    assert got is fresh and got.step == state.step == 1 and counters == COUNTERS
    for a, b in ((got.generator, state.generator), (got.discriminator, state.discriminator)):
        sa, sb = a.state_dict(), b.state_dict()
        assert list(sa) == list(sb) and all(torch.equal(sa[k], sb[k]) for k in sb)
    for a, b in ((got.g_opt, state.g_opt), (got.d_opt, state.d_opt)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa["param_groups"] == sb["param_groups"] and sorted(sa["state"]) == sorted(sb["state"])
        assert all(torch.equal(sa["state"][i][n], sb["state"][i][n]) for i in sb["state"] for n in sb["state"][i])
    payload, counters = tckpt.load_snapshot(str(tmp_path), "model_00000001.ckpt")
    assert set(payload) == {"generator", "discriminator", "g_opt", "d_opt", "step", "counters"}
    with pytest.raises(FileNotFoundError, match="no snapshot"):
        tckpt.load_snapshot(str(tmp_path), "model_best.ckpt")


def test_load_keeps_the_running_optimizers_hyper_parameters(tmp_path):
    """load_snapshot restores the optimizers' moments and steps, not their
    param_groups: vfi_tpu's optax states hold no hyper-parameters, so a
    resumed run uses its own config's."""
    env = create_training_environment(create_model(SPEC), TrainConfig(**CFG))
    state = env.init_state((H, W), device="cpu", seed=2)
    torch.manual_seed(3)
    for p in state.generator.parameters():
        p.grad = torch.randn_like(p)
    state.g_opt.step()
    tckpt.save_snapshot(str(tmp_path), "model_latest.ckpt", state, COUNTERS)

    env2 = create_training_environment(create_model(SPEC), TrainConfig(**CFG, lr=3e-4, beta1=0.9))
    got, _ = tckpt.load_snapshot(str(tmp_path), "model_latest.ckpt", env2.init_state((H, W), device="cpu", seed=5))
    for opt in (got.g_opt, got.d_opt):
        assert [(g["lr"], g["betas"]) for g in opt.param_groups] == [(3e-4, (0.9, 0.999))]
    want = state.g_opt.state_dict()["state"]
    assert sorted(got.g_opt.state_dict()["state"]) == sorted(want) and len(want) > 0
    for p, q in zip(got.generator.parameters(), state.generator.parameters()):
        assert all(torch.equal(got.g_opt.state[p][n], state.g_opt.state[q][n])
                   for n in ("step", "exp_avg", "exp_avg_sq"))


def test_weight_and_adam_converters_invert_each_other():
    """params/disc/Adam converters: port -> JAX -> port and JAX -> port -> JAX, bit-exact."""
    g = random_jax_params(SPEC, 11)
    d = random_jax_disc_variables(TrainConfig(**CFG), H, W, 1, 12)
    for a, b in ((_flat(params_to_jax(params_from_jax(g))), _flat(g)),
                 (_flat(disc_variables_to_jax(disc_variables_from_jax(d))), _flat(d))):
        assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in b)
    sd = params_from_jax(g)
    names = list(sd)
    adam = {"count": np.asarray(7, np.int32), "mu": random_jax_params(SPEC, 13), "nu": random_jax_params(SPEC, 14)}
    torch_state = adam_state_from_jax(adam, names)
    assert all(float(s["step"]) == 7.0 for s in torch_state.values())
    back = adam_state_to_jax(torch_state, names, sd)
    assert back["count"] == 7 and back["count"].dtype == np.int32
    for key in ("mu", "nu"):
        a, b = _flat(back[key]), _flat(adam[key])
        assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in b)
    assert adam_state_from_jax({**adam, "count": np.asarray(0, np.int32)}, names) == {}
    zero = adam_state_to_jax({}, names, sd)
    assert zero["count"] == 0 and all(not v.any() for v in _flat(zero["mu"]).values())


def test_jax_to_port_to_jax_is_bit_exact(jax_run):
    root = jax_run["root"]
    want_state, want_counters = read_jax_snapshot(os.path.join(root, "jax", "model_latest.ckpt"))
    payload = to_torch_payload(want_state, want_counters, json.dumps(SPEC))
    tckpt.write_payload(os.path.join(root, "torch"), "model_latest.ckpt", payload)
    state, counters = to_jax_state(tckpt.load_snapshot(os.path.join(root, "torch"), "model_latest.ckpt")[0],
                                   json.dumps(SPEC), seed=0)
    jckpt.save_snapshot(os.path.join(root, "back"), "model_latest.ckpt", state, counters)
    got_state, got_counters = read_jax_snapshot(os.path.join(root, "back", "model_latest.ckpt"))

    got, want = _flat({**got_state, "counters": got_counters}), _flat({**want_state, "counters": want_counters})
    assert sorted(got) == sorted(want)
    assert int(want[("step",)]) == 2 and int(want[("g_opt", "0", "count")]) == 2
    for k in want:
        if k == ("rng",):  # not held by the port: init_state(PRNGKey(0))'s
            np.testing.assert_array_equal(got[k], np.asarray(jax.random.split(jax.random.PRNGKey(0), 3)[2]))
            continue
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_port_resumes_a_converted_snapshot_and_matches_the_third_step(jax_run):
    root = jax_run["root"]
    state, counters = read_jax_snapshot(os.path.join(root, "jax", "model_latest.ckpt"))
    tckpt.write_payload(os.path.join(root, "resume"), "model_latest.ckpt",
                        to_torch_payload(state, counters, json.dumps(SPEC)))
    env = create_training_environment(create_model(SPEC), TrainConfig(**CFG))
    tstate, tcounters = tckpt.load_snapshot(os.path.join(root, "resume"), "model_latest.ckpt",
                                            env.init_state((H, W), device="cpu", seed=9))
    assert tstate.step == 2 and tcounters == COUNTERS
    tstate, terms = env.train_step(tstate, K, T, F, jax_run["targets"])
    for k, want in jax_run["terms3"].items():
        assert abs(float(terms[k]) - want) <= 1e-4 * max(abs(want), 1e-12), (k, float(terms[k]), want)
    g = {n: p.grad for n, p in tstate.generator.named_parameters()}
    d = {n: p.grad for n, p in tstate.discriminator.named_parameters()}
    assert _global_rel(g, jax_run["g_grad3"]) <= 1e-4
    assert _global_rel(d, jax_run["d_grad3"]) <= 1e-4
    assert tstate.step == 3
    # The converted Adam state is what vfi_tpu used.  After the step, the
    # weights, the step's update and each parameter's moments (read through
    # the parameter, not the state's index) match vfi_tpu's step-3 state
    # within global-L2-relative 1e-4, and every step count is 3: swapped or
    # misplaced moments fail the moments, a wrong count (bias correction)
    # fails the update.
    assert jax_run["count3"] == (3, 3)
    before = {"generator3": params_from_jax(state["g_params"]),
              "discriminator3": disc_variables_from_jax({"params": state["d_params"], "sn": state["d_sn"]})}
    for module, opt, want, (mu, nu) in ((tstate.generator, tstate.g_opt, "generator3", jax_run["g_moments3"]),
                                        (tstate.discriminator, tstate.d_opt, "discriminator3",
                                         jax_run["d_moments3"])):
        got, w3, w2 = module.state_dict(), jax_run[want], before[want]
        assert _global_rel(got, w3) <= 1e-4, want  # the discriminator's u buffers included
        named = dict(module.named_parameters())
        assert _global_rel({n: got[n] - w2[n] for n in named}, {n: w3[n] - w2[n] for n in named}) <= 1e-4, want
        assert all(float(opt.state[p]["step"]) == 3.0 for p in named.values())
        assert _global_rel({n: opt.state[p]["exp_avg"] for n, p in named.items()}, mu) <= 1e-4, want
        assert _global_rel({n: opt.state[p]["exp_avg_sq"] for n, p in named.items()}, nu) <= 1e-4, want

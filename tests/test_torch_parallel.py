"""vfi_tpu_torch.parallel on the CPU: two gloo ranks (tests/torch_dist_worker.py,
spawned once for the module) gather uneven rows, average through one
collective, replicate a diverged training state bit for bit, check
``--mesh_shape``, and take two f32 steps of the toy TAI of
tests/_mp_worker.py at a local batch of 2; the steps are held against the
port's one-process step and vfi_tpu's ``train_step`` on the global batch of
4.  Then the device rule of a launch, and that every training environment
averages its gradients over its group."""

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp
from vfi_tpu.models.fill_in import TAIFillInModel as JTAI
from vfi_tpu.nn.discriminator import SNDiscriminator as JDisc
from vfi_tpu.train import environments as jenvs
from vfi_tpu.utils.config import TrainConfig as JTrainConfig
from vfi_tpu_torch.api import resolve_device
from vfi_tpu_torch.models.registry import create_model
from vfi_tpu_torch.parallel import mesh
from vfi_tpu_torch.train import environments
from vfi_tpu_torch.train.environments import create_training_environment
from vfi_tpu_torch.utils.config import TrainConfig
from vfi_tpu_torch.utils.params import disc_variables_from_jax, params_from_jax, random_jax_disc_variables, random_jax_params
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)
from . import torch_dist_worker as worker

WORLD = 2
K, T, F, H, W = worker.K, worker.T, worker.F, worker.H, worker.W
GLOBAL_B = worker.LOCAL_B * WORLD


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _global_rel(got: dict, want: dict) -> float:
    """Global-L2-relative error over every leaf (tests/test_grad_parity.py's measure)."""
    assert sorted(got) == sorted(want)
    num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in want)
    den = sum(float((want[k].double() ** 2).sum()) for k in want)
    return (num / den) ** 0.5


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The converted weights and the global batch; the two ranks' results;
    the port's one-process two steps on the global batch."""
    root = tmp_path_factory.mktemp("parallel")
    g_params = random_jax_params(worker.SPEC, seed=40)
    d_vars = random_jax_disc_variables(TrainConfig(**worker.CFG), H, W, 1, seed=41)
    targets = np.random.RandomState(42).uniform(-1, 1, (GLOBAL_B, K + T + F, H, W, 1)).astype(np.float32)
    inputs = {"generator": params_from_jax(g_params), "discriminator": disc_variables_from_jax(d_vars),
              "targets": targets}
    torch.save(inputs, root / "inputs.pt")
    mp.spawn(worker.run, args=(WORLD, str(root)), nprocs=WORLD, join=True)
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]

    env, state = worker.toy_state(None, inputs)
    steps, grads = [], None
    for i in range(2):
        state, terms = env.train_step(state, K, T, F, targets)
        steps.append({k: float(v) for k, v in terms.items()})
        if i == 0:
            grads = ({n: p.grad.clone() for n, p in state.generator.named_parameters()},
                     {n: p.grad.clone() for n, p in state.discriminator.named_parameters()})
    one = {"steps": steps, "grads": grads, "state": worker.state_tensors(state)}
    return dict(g_params=g_params, d_vars=d_vars, targets=targets, ranks=ranks, one=one)


def test_allgather_rows_keeps_uneven_counts_and_nan_rows(run):
    for r in run["ranks"]:
        rows = r["rows_3_0"]
        assert rows.shape == (3, T) and int(np.isnan(rows).sum()) == 1 and np.isnan(rows[1, -1])
        np.testing.assert_array_equal(r["rows_1_2"], np.asarray([[0.0] * T, [1.0] * T, [1.0] * T], np.float32))


def test_allgather_rows_is_a_no_op_in_one_process():
    rows = np.arange(6.0).reshape(3, 2)
    assert mesh.allgather_rows(rows) is rows
    assert mesh.world_size() == 1 and mesh.rank() == 0 and mesh.is_main()
    assert mesh.init_distributed(torch.device("cpu")) is None  # WORLD_SIZE unset


def test_allreduce_mean_is_one_collective_of_one_flat_buffer(run):
    for r in run["ranks"]:
        assert r["allreduce_calls"] == [12 + 5 + 1]
        a, b, c = r["allreduce_values"]
        assert torch.equal(a, torch.full((3, 4), 0.5)) and torch.equal(b, torch.arange(5.0) * 1.5)
        assert torch.equal(c, torch.tensor(1.0))


@pytest.mark.parametrize("case", ["diverged", "filled"])
def test_replicate_state_gives_every_rank_rank0s_state(run, case):
    """Weights, SN's u, Adam's moments and steps, the step and the generator's
    state, bit for bit; ``filled``: rank 1's optimizers held no state."""
    got, want = run["ranks"][1][case], run["ranks"][0][case]
    assert sorted(got) == sorted(want)
    assert any(k.startswith("g_opt.") and k.endswith("exp_avg_sq") for k in want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("shape", [(2,), (2, 1), (2, 2), (4,)])
def test_make_mesh_checks_the_mesh_shape_against_the_launch(run, shape):
    got = [r["make_mesh"][shape] for r in run["ranks"]]
    if shape in ((2,), (2, 1)):
        assert got == [(2, 1), (2, 1)] and mesh.make_mesh(shape, world=2) == (2, 1)
    else:
        for msg in got:
            assert str(shape[-1]) in msg and "2" in msg, msg
        with pytest.raises(ValueError, match=str(shape[-1])):
            mesh.make_mesh(shape, world=2)


def test_two_rank_steps_keep_the_ranks_bit_identical(run):
    a, b = (r["state"] for r in run["ranks"])
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert run["ranks"][0]["steps"] == run["ranks"][1]["steps"]


def test_two_rank_steps_equal_the_one_process_step_on_the_global_batch(run):
    """The parameters and Adam states after two steps and the ranks' mean terms
    of both steps, within global-L2-relative 1e-5."""
    got, want = run["ranks"][0], run["one"]
    assert _global_rel({k: v for k, v in got["state"].items() if k != "step"},
                       {k: v for k, v in want["state"].items() if k != "step"}) <= 1e-5
    assert got["state"]["step"] == want["state"]["step"] == 2
    for g, w in zip(got["steps"], want["steps"]):
        assert sorted(g) == sorted(w)
        err = _global_rel({k: torch.tensor(v) for k, v in g.items()}, {k: torch.tensor(v) for k, v in w.items()})
        assert err <= 1e-5, (g, w)


@pytest.fixture(scope="module")
def jax_step(run):
    """vfi_tpu's first step on the global batch from the same weights; its
    gradients are read from Adam's first moment (b1 = 0.5)."""
    jenv = jenvs.create_training_environment(JTAI(**worker.SPEC["kwargs"]), JTrainConfig(**worker.CFG))
    jenv.discriminator = JDisc(window_size=worker.CFG["disc_window_size"], df_dim=worker.CFG["df_dim"],
                               Ip=worker.CFG["Ip"])
    gp, dp, dsn = (jax.tree.map(jnp.asarray, t)
                   for t in (run["g_params"], run["d_vars"]["params"], run["d_vars"]["sn"]))
    jstate = jenvs.TrainState(step=jnp.zeros((), jnp.int32), g_params=gp, g_opt=jax.jit(jenv.g_tx().init)(gp),
                              d_params=dp, d_sn=dsn, d_opt=jax.jit(jenv.d_tx().init)(dp), rng=jax.random.PRNGKey(0))
    jstate, m = jenv.train_step(jstate, K, T, F, run["targets"])
    b1 = jenv.cfg.beta1
    g, d = (jax.tree.map(lambda a: np.asarray(a) / (1.0 - b1), o[0].mu) for o in (jstate.g_opt, jstate.d_opt))
    return {k: float(v) for k, v in m.items()}, params_from_jax(g), disc_variables_from_jax({"params": d})


def test_two_rank_first_step_terms_match_vfi_tpu(run, jax_step):
    want = jax_step[0]
    got = run["ranks"][0]["steps"][0]
    assert sorted(got) == sorted(want)
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-3, (k, got[k], want[k])


@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_two_rank_first_step_gradients_match_vfi_tpu(run, jax_step, net):
    i = 0 if net == "generator" else 1
    for r in run["ranks"]:
        assert _global_rel(r["grads"][i], jax_step[1 + i]) <= 1e-3


def test_a_launch_gives_each_rank_its_own_card(monkeypatch):
    """``cuda`` under torchrun is cuda:LOCAL_RANK, and a rank without a card
    raises; an explicit card and the CPU stay as given; the backend is gloo
    on the CPU and where ranks share a card, NCCL otherwise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert resolve_device("cuda") == torch.device("cuda", 1) == resolve_device(None)
    assert resolve_device("cuda:0") == torch.device("cuda", 0) and resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="LOCAL_RANK=2"):
        resolve_device("cuda")
    monkeypatch.delenv("LOCAL_RANK")
    assert resolve_device("cuda") == torch.device("cuda")
    assert mesh.choose_backend(torch.device("cpu"), 1) == "gloo"
    assert mesh.choose_backend(torch.device("cuda", 1), 2) == "nccl"
    assert mesh.choose_backend(torch.device("cuda", 0), 4) == "gloo"


def _toy_env(kind: str, group):
    if kind == "tai":
        env = create_training_environment(create_model(worker.SPEC), TrainConfig(**worker.CFG), group)
        return env, env.init_state((H, W), device="cpu"), 2, H
    if kind == "sct":
        spec = {"class": "SCTSkipConScaledTForwardFillInModel",
                "kwargs": dict(num_blocks=1, num_heads=2, d_v=16, d_ff=32, c_dim=1)}
        env = create_training_environment(create_model(spec), TrainConfig(**worker.CFG, tf_p_min=1.0, tf_p_max=1.0),
                                          group)
        return env, env.init_state((16, 16), device="cpu"), 2, 16
    spec = {"class": "SloMoFillInModel", "kwargs": dict(base_dim=4, c_dim=1, warp_mode="pixel")}
    env = create_training_environment(create_model(spec), TrainConfig(K=K, T=T, F=F, lambda_p=0.0), group)
    return env, env.init_state((H, W), device="cpu"), 1, H


@pytest.mark.parametrize("kind", ["tai", "sct", "slomo"])
def test_every_environment_averages_its_gradients_over_its_group(kind, monkeypatch):
    """Each update of each environment's step hands all of its network's
    gradients to one all-reduce over the environment's group (a stand-in)."""
    calls, group = [], object()
    monkeypatch.setattr(environments, "allreduce_mean_", lambda tensors, g: calls.append((len(tensors), g)))
    env, state, updates, hw = _toy_env(kind, group)
    targets = np.random.RandomState(5).uniform(-1, 1, (1, K + T + F, hw, hw, 1)).astype(np.float32)
    env.train_step(state, K, T, F, targets)
    nets = [state.generator, state.discriminator][:updates]
    assert calls == [(len(list(n.parameters())), group) for n in nets]

"""Rank processes for tests/test_torch_parallel.py (``torch.multiprocessing.spawn``).

Each rank joins a gloo group over a file in the test's directory, with a
timeout so that ranks that fall out of step fail instead of hanging, runs
the jobs below and saves what it saw to ``<root>/rank<r>.pt`` for the test
process to compare.  Imports nothing of JAX.
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from vfi_tpu_torch.models.registry import create_model
from vfi_tpu_torch.parallel import mesh
from vfi_tpu_torch.train.environments import create_training_environment, mean_terms
from vfi_tpu_torch.utils.config import TrainConfig

TIMEOUT = datetime.timedelta(seconds=120)
# The toy TAI of tests/_mp_worker.py.
SPEC = {"class": "TAIFillInModel", "kwargs": dict(gf_dim=8, c_dim=1, ks=5, num_block=5, kf_dim=4)}
CFG = dict(K=2, T=2, F=2, df_dim=8, Ip=1, disc_window_size=3)
K, T, F, H, W = 2, 2, 2, 32, 32
LOCAL_B = 2


def toy_state(group=None, inputs=None):
    """The toy TAI's environment and a state on the CPU, from ``inputs``'
    weights where given."""
    env = create_training_environment(create_model(SPEC), TrainConfig(**CFG), group)
    state = env.init_state((H, W), device="cpu")
    if inputs is not None:
        state.generator.load_state_dict(inputs["generator"])
        state.discriminator.load_state_dict(inputs["discriminator"])
    return env, state


def state_tensors(state) -> dict:
    """Every tensor of a training state by name, copied: weights, buffers,
    both Adam states, the step and the generator's state."""
    out = {f"g.{k}": v.clone() for k, v in state.generator.state_dict().items()}
    out.update({f"d.{k}": v.clone() for k, v in state.discriminator.state_dict().items()})
    for tag, opt in (("g_opt", state.g_opt), ("d_opt", state.d_opt)):
        for i, p in enumerate(q for g in opt.param_groups for q in g["params"]):
            out.update({f"{tag}.{i}.{k}": v.clone() for k, v in opt.state[p].items()})
    out["step"] = torch.tensor(state.step)
    if state.rng is not None:
        out["rng"] = state.rng.get_state()
    return out


def collectives(rank: int, groups: mesh.Groups) -> dict:
    out = {"make_mesh": {}}
    # Uneven rows: 3 (one of them NaN) and 0; then 1 and 2, in rank order.
    rows = np.full((3, T), 7.0, np.float32) if rank == 0 else np.zeros((0, T), np.float32)
    if rank == 0:
        rows[1, -1] = np.nan
    out["rows_3_0"] = mesh.allgather_rows(rows, groups.host)
    out["rows_1_2"] = mesh.allgather_rows(np.full((rank + 1, T), float(rank), np.float32), groups.host)

    calls = []
    all_reduce = dist.all_reduce

    def counted(*args, **kwargs):
        calls.append(args[0].numel())
        return all_reduce(*args, **kwargs)

    tensors = [torch.full((3, 4), float(rank)), torch.arange(5.0) * (rank + 1), torch.tensor(2.0 * rank)]
    dist.all_reduce = counted
    try:
        mesh.allreduce_mean_(tensors, groups.device)
    finally:
        dist.all_reduce = all_reduce
    out["allreduce_calls"], out["allreduce_values"] = calls, tensors

    for shape in ((2,), (2, 1), (2, 2), (4,)):
        try:
            out["make_mesh"][shape] = mesh.make_mesh(shape)
        except ValueError as e:
            out["make_mesh"][shape] = str(e)

    # replicate_state: rank 1's state diverges in every part (weights, SN's u,
    # Adam's moments and steps, the step, the generator), then takes rank 0's.
    gen = torch.Generator().manual_seed(100 + rank)
    targets = torch.rand((LOCAL_B, K + T + F, H, W, 1), generator=gen) * 2 - 1
    env, state = toy_state()
    state.rng = torch.Generator().manual_seed(rank)
    with torch.no_grad():
        for p in state.generator.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 1e-3 * rank)
    for _ in range(rank + 1):
        env.train_step(state, K, T, F, targets)
    out["diverged"] = state_tensors(mesh.replicate_state(state, groups))
    # A rank whose optimizers hold no state yet (rank 0 alone resumed).
    env, state = toy_state()
    if rank == 0:
        env.train_step(state, K, T, F, targets)
    out["filled"] = state_tensors(mesh.replicate_state(state, groups))
    return out


def train_steps(rank: int, groups: mesh.Groups, root: str) -> dict:
    """Two f32 steps of the toy TAI on this rank's rows of the global batch."""
    inputs = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    env, state = toy_state(groups.device, inputs)
    mesh.replicate_state(state, groups)
    local = inputs["targets"][rank * LOCAL_B:(rank + 1) * LOCAL_B]
    steps, grads = [], None
    for i in range(2):
        state, terms = env.train_step(state, K, T, F, local)
        steps.append(mean_terms(terms, groups.device))
        if i == 0:
            grads = ({n: p.grad.clone() for n, p in state.generator.named_parameters()},
                     {n: p.grad.clone() for n, p in state.discriminator.named_parameters()})
    return {"steps": steps, "grads": grads, "state": state_tensors(state)}


def run(rank: int, world: int, root: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(root, 'rendezvous')}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    groups = mesh.Groups(dist.group.WORLD, dist.new_group(backend="gloo", timeout=TIMEOUT), False)
    try:
        out = collectives(rank, groups)
        out.update(train_steps(rank, groups, root))
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()

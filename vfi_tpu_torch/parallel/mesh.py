"""Data parallelism over processes (counterpart of ``vfi_tpu/parallel/mesh.py``).

vfi_tpu runs one controller per host over a ``jax.sharding.Mesh`` with a
"data" axis and a "model" axis; XLA inserts the collectives that its
shardings imply.  The port runs one process per card, as PyTorch does, and
states each collective, over ``torch.distributed``:

    torchrun --nproc_per_node N -m vfi_tpu_torch.cli.train ...

========================================  ======================================
vfi_tpu                                   port
========================================  ======================================
``jax.distributed.initialize``            :func:`init_distributed`
``jax.process_index`` / ``process_count`` :func:`rank` / :func:`world_size`
``make_mesh(shape)``                      :func:`make_mesh`: checks ``--mesh_shape``
                                          against the launch
``shard_batch``, ``batch_sharding``       none: each rank loads only its own rows
                                          (``batch_iterator(..., num_shards,
                                          shard_index)``)
the gradient all-reduce XLA inserts       :func:`allreduce_mean_`
``allgather_rows``                        :func:`allgather_rows`
``replicate_state``, ``replicated``       :func:`replicate_state`
========================================  ======================================

There is no "model" axis: vfi_tpu reserves one of size 1 that shards nothing,
and :func:`make_mesh` refuses a larger one.

A launch has two groups (:class:`Groups`).  ``device`` carries the tensors on
the run's device: NCCL, or gloo on the CPU and where ranks share a card
(NCCL refuses two ranks on one device).  ``host`` is always gloo, for what
lives on the host (numpy rows, counters, a ``torch.Generator``'s state),
which NCCL cannot carry.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


class Groups(NamedTuple):
    """The process groups of a launch; ``owned`` when :func:`init_distributed`
    created the default group (and :func:`shutdown` destroys it)."""

    device: dist.ProcessGroup
    host: dist.ProcessGroup
    owned: bool


def world_size(group: Optional[dist.ProcessGroup] = None) -> int:
    """The number of ranks; 1 without a process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0: the one process that prints and writes files."""
    return rank() == 0


def choose_backend(device: torch.device, local_world: int) -> str:
    """gloo on the CPU and where ``local_world`` ranks must share this host's
    cards; NCCL where each rank has a card of its own."""
    if device.type != "cuda" or local_world > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def init_distributed(device: torch.device) -> Optional[Groups]:
    """Join the launch that torchrun describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).

    Returns None in one process (``WORLD_SIZE`` unset or 1).  Where the caller
    has set up the default group itself, that group is used, whatever its
    size.  The backend is :func:`choose_backend`'s, printed on rank 0.
    ``device`` is the rank's own (``api.resolve_device``); a card becomes the
    current device before NCCL's group is made.
    """
    owned = not dist.is_initialized()
    if owned:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return None
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        backend = choose_backend(device, local_world)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend)  # env://: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT
    backend = dist.get_backend()
    groups = Groups(dist.group.WORLD, dist.new_group(backend="gloo"), owned)
    if is_main():
        why = ("the caller's group" if not owned else
               "a card per rank" if backend == "nccl" else "the CPU, or ranks sharing a card")
        print(f"torch.distributed: {world_size()} ranks, backend {backend} ({why}); rank 0 on {device}", flush=True)
    return groups


def shutdown(groups: Optional[Groups]) -> None:
    """Destroy what :func:`init_distributed` created."""
    if groups is None:
        return
    dist.destroy_process_group(groups.host)
    if groups.owned:
        dist.destroy_process_group()


def make_mesh(shape: Optional[Sequence[int]] = None, world: Optional[int] = None) -> tuple:
    """Check ``--mesh_shape`` against a launch of ``world`` ranks (default:
    this one's) and return it as ``(data, model)``.  ``(world,)`` and
    ``(world, 1)`` are accepted; a "model" axis larger than 1 or a data axis
    other than the world raises ``ValueError``."""
    world = world_size() if world is None else world
    shape = (world, 1) if shape is None else tuple(int(n) for n in shape)
    if len(shape) == 1:
        shape = (shape[0], 1)
    if len(shape) != 2:
        raise ValueError(f"--mesh_shape {list(shape)}: give (data,) or (data, model)")
    if shape[1] != 1:
        raise ValueError(f"--mesh_shape {list(shape)}: a model axis of {shape[1]} is not supported (only 1); "
                         f"the data axis must be the {world} ranks of the launch")
    if shape[0] != world:
        raise ValueError(f"--mesh_shape {list(shape)}: a data axis of {shape[0]} against a launch of {world} ranks")
    return shape


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    dtypes = {(t.dtype, t.device) for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"one flat buffer needs one dtype and device, got {sorted(map(str, dtypes))}")
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat_(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    for t, chunk in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(chunk.view_as(t))


def allreduce_mean_(tensors: Sequence[torch.Tensor], group: Optional[dist.ProcessGroup] = None) -> None:
    """Average ``tensors`` over the ranks of ``group``, in place, through one
    flattened buffer (one collective per call, not one per tensor).  They
    must share a dtype and a device.  Every rank ends with the same bits."""
    tensors = list(tensors)
    if not tensors or not dist.is_initialized():
        return
    flat = _flat(tensors)
    dist.all_reduce(flat, group=group)
    flat /= world_size(group)
    _unflat_(flat, tensors)


def allgather_rows(rows: np.ndarray, group: Optional[dist.ProcessGroup] = None) -> np.ndarray:
    """Concatenate each rank's result rows, in rank order, into the same global
    array on every rank (the validation sweep's per-video curves).

    Counts may differ per rank (videolist shards are uneven, and a shard may
    be empty): each rank's rows are zero-padded to the largest count and cut
    back by count after the gather, never by a sentinel, so a NaN row is kept.
    ``group`` must be gloo (``Groups.host``).  A no-op without a process group.
    """
    if not dist.is_initialized():
        return rows
    rows = np.asarray(rows, np.float32)
    world = world_size(group)
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(counts, torch.tensor([rows.shape[0]]), group=group)
    counts = [int(c) for c in counts]
    if max(counts) == 0:
        return rows
    padded = torch.zeros((max(counts),) + rows.shape[1:], dtype=torch.float32)
    padded[: rows.shape[0]] = torch.from_numpy(rows)
    gathered = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(gathered, padded, group=group)
    return np.concatenate([g[:c].numpy() for g, c in zip(gathered, counts)])


def broadcast_object(obj, group: Optional[dist.ProcessGroup] = None):
    """Rank 0's ``obj`` on every rank (``group``: gloo); ``obj`` itself
    without a process group."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def broadcast_(tensors: Sequence[torch.Tensor], group: Optional[dist.ProcessGroup]) -> None:
    """Rank 0's values of ``tensors`` on every rank, in place: one flat buffer
    per dtype and device.  A no-op without a process group."""
    if not dist.is_initialized():
        return
    buckets = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for ts in buckets.values():
        flat = _flat(ts)
        dist.broadcast(flat, src=0, group=group)
        _unflat_(flat, ts)


def _slots(param_state: dict) -> dict:
    """An optimizer's state of one parameter as {key: (shape, dtype, on the CPU)}."""
    return {k: (tuple(v.shape), v.dtype, v.device.type == "cpu") for k, v in sorted(param_state.items())}


def replicate_state(state, groups: Optional[Groups]):
    """Make every rank's training state (``train.environments.TrainState``)
    rank 0's, bit for bit, in place: the generator's and the discriminator's
    parameters and buffers (SN's ``u``), both Adam states (``exp_avg``,
    ``exp_avg_sq``, ``step``; a rank whose optimizer has no state yet, as
    after a resume on rank 0 alone, is given rank 0's), ``state.step`` and
    the state's CPU ``torch.Generator``.  Returns the state; a no-op in one
    process."""
    if groups is None:
        return state
    opts = [[(o, p) for g in o.param_groups for p in g["params"]] for o in (state.g_opt, state.d_opt)
            if o is not None]
    skeletons, state.step = broadcast_object(([[_slots(o.state[p]) for o, p in ps] for ps in opts], state.step),
                                             groups.host)
    on_device, on_host = [], []
    for module in (state.generator, state.discriminator):
        if module is not None:
            on_device += list(module.state_dict().values())
    for ps, skeleton in zip(opts, skeletons):
        for (opt, p), keys in zip(ps, skeleton):
            st = opt.state[p]
            if _slots(st) != keys:
                st.clear()
                for k, (shape, dtype, cpu) in keys.items():
                    st[k] = torch.zeros(shape, dtype=dtype, device="cpu" if cpu else p.device)
            for k, (_, _, cpu) in keys.items():
                (on_host if cpu else on_device).append(st[k])
    if state.rng is not None:
        rng = state.rng.get_state()
        broadcast_([rng], groups.host)
        state.rng.set_state(rng)
    broadcast_(on_device, groups.device)
    broadcast_(on_host, groups.host)
    return state

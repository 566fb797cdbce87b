"""Data parallelism over ``torch.distributed`` (counterpart of
``dpfx/parallel/mesh.py`` and ``dpfx/parallel/distributed.py``): one
process per GPU, each a rank of one process group, the data axis being the
ranks.

A run over D ranks computes each update from the same global batch and the
same global noise as a one-process run; rank r takes rows
``[r B/D, (r+1) B/D)`` of them. Only two collectives are used, which every
backend takes on the tensors it needs (NCCL on the cards, gloo on the CPU,
gloo with CUDA tensors for ranks sharing one card): ``all_reduce`` (sum) and
``broadcast``. A gather is a masked all-reduce (``gather_rows``), as
``dpfx`` writes it under ``shard_map``: each rank writes the rows it owns
into zeros and the sum assembles them, exactly, since one rank gives each
row.

Without a group (``group=None``) every helper is the one-process identity.
"""

from __future__ import annotations

import importlib
import os
import socket
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dpfx_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor
Group = Optional[dist.ProcessGroup]


def world_rank(group: Group) -> Tuple[int, int]:
    """(ranks in ``group``, this process's rank); (1, 0) without a group."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def is_coordinator(group: Group = None) -> bool:
    """True on rank 0, and in a process without a group."""
    return world_rank(group)[1] == 0


def capturable(group: Group) -> bool:
    """Whether ``group``'s collectives can be captured in a CUDA graph: NCCL's
    can, gloo's cannot."""
    return group is None or dist.get_backend(group) == "nccl"


def rank_seed(seed: int, rank: int) -> int:
    """An integer seed keyed by (seed, rank): a rank's own streams (the
    sampler's clouds, the packed loader's batches)."""
    state = np.random.SeedSequence((seed, rank)).generate_state(1, np.uint64)[0]
    return int(state) & (2**63 - 1)


# ---------------------------------------------------------------- start-up

def visible_cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def ranks_to_spawn(pcfg, device: DeviceLike = None) -> int:
    """How many ranks a lone process should start for ``parallel.data_axis``:
    n > 0 asks for n (one card each on cuda; n processes on the CPU), -1 for
    every visible card (exactly 1 on the CPU). 1 when this process is
    already a rank (``parallel.coordinator`` or torchrun's environment).
    Raises when the cards asked for are more than the visible ones, as
    ``dpfx``'s ``create_mesh`` does."""
    if pcfg.data_axis == 0 or pcfg.data_axis < -1:
        raise ValueError(f"parallel.data_axis must be -1 (all) or positive, got {pcfg.data_axis}")
    if pcfg.coordinator or "WORLD_SIZE" in os.environ:
        return 1
    dev = resolve_device(device)
    if dev.type == "cpu":
        return max(pcfg.data_axis, 1)
    visible = visible_cards()
    if pcfg.data_axis > visible:
        raise ValueError(f"parallel.data_axis={pcfg.data_axis} cards requested but only "
                         f"{visible} are visible")
    return visible if pcfg.data_axis == -1 else pcfg.data_axis


def init_from_config(pcfg, device: DeviceLike = None, group: Group = None
                     ) -> Tuple[Group, torch.device]:
    """The process group and this rank's device (counterpart of
    ``initialize_from_config``). ``parallel.coordinator`` ("host:port"),
    ``num_processes`` and ``process_id`` give
    ``init_process_group(init_method="tcp://...")``; without them torchrun's
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` are read; with neither the process runs alone and the
    group is None. The backend is NCCL on cuda and gloo on the CPU; rank r
    of a host takes ``cuda:LOCAL_RANK``. A caller's own ``group`` is
    returned as it is, with ``device``. Raises when
    ``parallel.data_axis`` or ``num_processes`` disagree with the ranks, and
    when a lone process asks for more cards than are visible."""
    dev = resolve_device(device)
    if group is not None:
        return group, dev
    env = os.environ
    if pcfg.coordinator:
        if pcfg.num_processes < 1 or pcfg.process_id < 0:
            raise ValueError(f"parallel.coordinator={pcfg.coordinator!r} needs "
                             "parallel.num_processes and parallel.process_id")
        world, rank, init = pcfg.num_processes, pcfg.process_id, f"tcp://{pcfg.coordinator}"
        local = int(env.get("LOCAL_RANK", rank % max(visible_cards(), 1)))
    elif "WORLD_SIZE" in env:
        world, rank, init = int(env["WORLD_SIZE"]), int(env["RANK"]), "env://"
        local = int(env.get("LOCAL_RANK", 0))
    else:
        if pcfg.num_processes > 1:
            raise ValueError(f"parallel.num_processes={pcfg.num_processes} needs "
                             "parallel.coordinator (or torchrun's RANK and WORLD_SIZE)")
        ranks_to_spawn(pcfg, dev)       # raises when more cards are asked for than are visible
        return None, dev
    if pcfg.num_processes > 0 and pcfg.num_processes != world:
        raise ValueError(f"parallel.num_processes={pcfg.num_processes} for {world} ranks")
    if pcfg.data_axis > 0 and pcfg.data_axis != world:
        raise ValueError(f"parallel.data_axis={pcfg.data_axis} for a group of {world} ranks")
    if dev.type == "cuda":
        if local >= visible_cards():
            raise ValueError(f"rank {rank} would take cuda:{local} but only {visible_cards()} "
                             "cards are visible")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init,
                                world_size=world, rank=rank)
    return dist.group.WORLD, dev


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(index: int, world: int, port: int, module: str, fn: str, args: Sequence) -> None:
    os.environ.update(RANK=str(index), WORLD_SIZE=str(world), LOCAL_RANK=str(index),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    getattr(importlib.import_module(module), fn)(*args)


def spawn(module: str, fn: str, n: int, args: Sequence = ()) -> None:
    """Run ``module.fn(*args)`` in n new processes, ranks 0..n-1 of one host
    (torchrun's environment, a free local port); waits for all of them and
    raises if one fails (the others are then stopped)."""
    import torch.multiprocessing as mp

    mp.spawn(_rank_entry, args=(n, free_port(), module, fn, tuple(args)), nprocs=n, join=True)


# ---------------------------------------------------------------- rows

def padded_rows(n_rows: int, world: int) -> int:
    """Rows after padding to a multiple of the ranks (the pad repeats rows
    and is never drawn: the draw indexes [0, n_rows))."""
    return -(-n_rows // world) * world


def process_local_rows(n_rows: int, world: int, rank: int) -> Tuple[int, int]:
    """[start, stop) of the padded row range rank ``rank`` owns: contiguous
    blocks of ``padded_rows(n_rows, world) / world`` rows in rank order."""
    per = padded_rows(n_rows, world) // world
    return rank * per, (rank + 1) * per


def shard_resident_stack(stack, world: int, rank: int, device: DeviceLike,
                         is_local_shard: bool = False) -> Tensor:
    """This rank's padded block of a resident stack [S, ...] on ``device``
    (ceil(S/D) rows; the pad repeats rows cyclically). With
    ``is_local_shard`` the stack is already that block (loaded alone)."""
    stack = np.asarray(stack, np.float32)
    if not is_local_shard:
        s = stack.shape[0]
        start, stop = process_local_rows(s, world, rank)
        stack = stack[np.arange(start, stop) % s]
    return torch.as_tensor(stack).to(device)


def rank_slice(t: Tensor, group: Group, dim: int = 0) -> Tensor:
    """This rank's rows [r n/D, (r+1) n/D) of ``t`` along ``dim``; raises
    unless D divides them. The tensor itself without a group."""
    world, rank = world_rank(group)
    if world == 1:
        return t
    n = t.shape[dim]
    if n % world:
        raise ValueError(f"{n} rows do not divide over {world} ranks")
    per = n // world
    return t.narrow(dim, rank * per, per).contiguous()


def gather_rows(block: Tensor, ids: Tensor, group: Group, points: Optional[Tensor] = None
                ) -> Tensor:
    """Rows ``ids`` (global row ids, any shape) of a row-sharded stack whose
    rows [r R, (r+1) R) this rank holds as ``block`` [R, ...], on every rank:
    each rank takes the rows it owns, zeros elsewhere, and an all-reduce
    sums them, which is exact (one rank gives each row). ``points`` (ids
    shape + [N]) picks points along axis 1 of each row before the
    all-reduce, which then moves [.., N, ...] rows, not whole ones."""
    world, rank = world_rank(group)
    r = block.shape[0]
    lid = ids - rank * r
    own = (lid >= 0) & (lid < r)
    lid = lid.clamp(0, r - 1)
    if points is None:
        rows = block[lid]
    else:
        p = block.shape[1]
        rows = block.reshape(r * p, *block.shape[2:])[lid[..., None] * p + points]
    if group is None:
        return rows
    own = own.reshape(own.shape + (1,) * (rows.ndim - own.ndim))
    rows = torch.where(own, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    dist.all_reduce(rows, group=group)
    return rows


def all_reduce_mean_(t: Tensor, group: Group) -> Tensor:
    """``t`` summed over the ranks and divided by their number, in place
    (``dpfx``'s ``pmean``); untouched without a group."""
    world = world_rank(group)[0]
    if group is not None:
        dist.all_reduce(t, group=group)
        if world > 1:
            t.div_(world)
    return t


def broadcast_(tensors: Sequence[Tensor], group: Group, src: int = 0) -> None:
    """Every tensor of ``tensors`` takes rank ``src``'s value, in place."""
    if group is None:
        return
    root = dist.get_global_rank(group, src)
    for t in tensors:
        dist.broadcast(t, root, group=group)

"""Data parallelism: one process per GPU over ``torch.distributed``
(counterpart of ``dpfx.parallel``)."""

from dpfx_torch.parallel.distributed import (
    Group,
    all_reduce_mean_,
    broadcast_,
    capturable,
    free_port,
    gather_rows,
    init_from_config,
    is_coordinator,
    padded_rows,
    process_local_rows,
    rank_seed,
    rank_slice,
    ranks_to_spawn,
    shard_resident_stack,
    spawn,
    world_rank,
)

__all__ = ["Group", "all_reduce_mean_", "broadcast_", "capturable", "free_port", "gather_rows",
           "init_from_config", "is_coordinator", "padded_rows", "process_local_rows", "rank_seed",
           "rank_slice", "ranks_to_spawn", "shard_resident_stack", "spawn", "world_rank"]

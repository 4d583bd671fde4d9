"""Data parallelism: one process a card in a ``torch.distributed`` group."""

from .mesh import (
    all_reduce_max, all_reduce_mean_, any_flag, barrier, broadcast_, init_distributed,
    local_device, rank, world_size,
)

__all__ = ["all_reduce_max", "all_reduce_mean_", "any_flag", "barrier", "broadcast_",
           "init_distributed", "local_device", "rank", "world_size"]

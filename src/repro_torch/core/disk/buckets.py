"""Block distribution of array indices over shards (the port's copy of
``repro/core/disk/buckets.py:87-95``).  The distance oracle's sharded
front routes queries by it, and its artifacts pin its values for 1, 2, 4
and 8 shards."""
from __future__ import annotations

import torch


def block_size(n: int, nshards: int) -> int:
    """Rows per shard under block distribution (ceil — last shard short)."""
    return -(-n // nshards)


def block_owner(idx, n: int, nshards: int) -> torch.Tensor:
    """Owner shard of each array index under block distribution, as int32
    on the indices' device (array-likes land on the CPU)."""
    per = block_size(n, nshards)
    return (torch.as_tensor(idx, dtype=torch.int64) // per).to(torch.int32)

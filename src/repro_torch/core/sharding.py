"""Owner maps of sharded Roomy structures (port of ``repro/core/sharding.py``).

Roomy distributes each structure across "disks" by a static owner
function; here the disks are the ranks of a process group.  Two owner
maps, matching the paper:

* arrays: block distribution — owner(i) = i // ceil(n / nshards)
* hash tables / lists: hash distribution — owner(x) = hash(x) % nshards

Both are bit-identical to the reference's and to its numpy mirrors in
``repro/core/disk/buckets.py``, which golden values in
``tests/test_cluster.py`` pin.  The reference's mesh helpers
(``shard_leading``, ``replicated``, ``axis_size``) wait for the port of
``distributed/`` (ROADMAP item 9.8).
"""
from __future__ import annotations

import torch

from . import types as T
from .disk.buckets import block_owner  # noqa: F401 — the one block map

__all__ = ["block_owner", "hash_owner"]


def hash_owner(rows: torch.Tensor, nshards: int) -> torch.Tensor:
    """Owner shard of each element/key row under hash distribution, as
    int32: the row's 32-bit hash read as unsigned, modulo ``nshards``."""
    h = T.hash_rows(rows).to(torch.int64) & T.UINT32_MASK
    return (h % nshards).to(torch.int32)

"""Owner maps of Tier D (the port's copy of
``repro/core/disk/buckets.py:69-95``): the numpy hash and block owners
that checkpoints pin as golden values and that ``DiskHashTable`` buckets
keys by, bit for bit the reference's, and the block owner on torch
tensors, by which the distance oracle's sharded front routes queries (its
artifacts pin its values for 1, 2, 4 and 8 shards)."""
from __future__ import annotations

import numpy as np
import torch


def hash_rows_np(rows: np.ndarray, seed: int = 0x9E3779B9) -> np.ndarray:
    """Numpy mirror of ``types.hash_rows`` — same FNV-ish mix, bit for bit."""
    rows = np.asarray(rows)
    h = np.full(rows.shape[:-1], np.uint32(seed), np.uint32)
    with np.errstate(over="ignore"):
        for j in range(rows.shape[-1]):
            w = rows[..., j].astype(np.uint32)
            h = (h ^ w) * np.uint32(0x01000193)
            h = h ^ (h >> np.uint32(15))
        h = h * np.uint32(0x85EBCA6B)
    return h ^ (h >> np.uint32(13))


def hash_owner_np(rows: np.ndarray, nshards: int) -> np.ndarray:
    """Owner shard of an element/key row under hash distribution."""
    return (hash_rows_np(rows) % np.uint32(nshards)).astype(np.int32)


def block_size(n: int, nshards: int) -> int:
    """Rows per shard under block distribution (ceil — last shard short)."""
    return -(-n // nshards)


def block_owner_np(idx: np.ndarray, n: int, nshards: int) -> np.ndarray:
    """Owner shard of array index idx under block distribution."""
    per = block_size(n, nshards)
    return (np.asarray(idx, np.int64) // per).astype(np.int32)


def block_owner(idx, n: int, nshards: int) -> torch.Tensor:
    """Owner shard of each array index under block distribution, as int32
    on the indices' device (array-likes land on the CPU)."""
    per = block_size(n, nshards)
    return (torch.as_tensor(idx, dtype=torch.int64) // per).to(torch.int32)

"""Carry state between the JAX package and the port, through numpy.

The JAX package keeps packed 2-bit words as uint32 arrays and ranks as
rows of uint32 words (word 0 high); the port keeps words as int32 tensors
with the same bits and ranks as int64.  These functions move state across
both ways, so the two packages can start from identical state.  They take
array-likes (numpy arrays, or anything ``np.asarray`` accepts, such as a
JAX array) and import nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from . import device as _device
from .core import bitarray as BA
from .core import ranking as R


def words_to_torch(words, device=None) -> torch.Tensor:
    """(W,) uint32 packed words → (W,) int32 tensor with the same bits."""
    w = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    return torch.from_numpy(w.view(np.int32).copy()).to(
        _device.resolve(device))


def words_to_numpy(t: torch.Tensor) -> np.ndarray:
    """(W,) int32 tensor → (W,) uint32 numpy words with the same bits."""
    return t.detach().cpu().numpy().view(np.uint32).copy()


def bitarray_from_jax(jax_bitarray, device=None) -> BA.RoomyBitArray:
    """A JAX ``RoomyBitArray``'s packed ``data`` as the port's array."""
    return BA.RoomyBitArray(words_to_torch(jax_bitarray.data, device))


def ranks_from_rows(rows, device=None) -> torch.Tensor:
    """(m, 1|2) uint32 rank rows (word 0 high) → (m,) int64 ranks."""
    rows = np.ascontiguousarray(np.asarray(rows, dtype=np.uint32))
    return R.rows_to_ranks(torch.from_numpy(rows.view(np.int32).copy())).to(
        _device.resolve(device))


def ranks_to_numpy(ranks: torch.Tensor) -> np.ndarray:
    """(m,) int64 ranks → (m,) uint64 numpy ranks (the numpy tier's type)."""
    return ranks.detach().cpu().numpy().astype(np.uint64)

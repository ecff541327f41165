"""RoomyBitArray — packed 2-bit-element array (port of ``repro/core/bitarray.py``).

16 two-bit elements per 32-bit word (int32 tensors holding the uint32
bits), so N states cost N/8 bytes of device memory.  A permutation's rank
(``ranking.py``) is its index; the element value is a BFS mark.

``mark_rotate_count`` is the implicit-BFS hot path: the delayed-mark
scatter and the rotate+count LUT pass fused into one kernel launch (K1).
``mark_packed`` / ``rotate_count`` are the unfused halves (K2, K3), kept as
the reference composition.  All dispatch through ``kernels/ops.py``.

The queued ``update`` / ``sync`` route and ``sharded_mark_sync`` are not
ported yet: they need the port of ``core/types.py`` and ``core/delayed.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import device as _device
from ..kernels import ops as K
from ..kernels.ref import FIELDS_PER_WORD, pack_fields, unpack_fields

# BFS mark values (the port's own copy of repro/core/disk/bitarray.py's);
# UNSEEN is 0 so a fresh array is all-unseen for free.
UNSEEN, CUR, NEXT, DONE = 0, 1, 2, 3

# LUT for the per-level rotate: CUR→DONE, NEXT→CUR, others fixed.
ROTATE_LUT = (UNSEEN << (2 * UNSEEN)) | (DONE << (2 * CUR)) \
    | (CUR << (2 * NEXT)) | (DONE << (2 * DONE))


class RoomyBitArray(NamedTuple):
    data: torch.Tensor    # (nwords,) int32 — packed 2-bit elements

    @property
    def capacity(self) -> int:
        return self.data.shape[0] * FIELDS_PER_WORD


def n_words(n: int) -> int:
    return -(-n // FIELDS_PER_WORD)


def make(n: int, device=None) -> RoomyBitArray:
    """An all-UNSEEN array of n elements on ``device`` (default ``"cuda"``)."""
    dev = _device.resolve(device)
    return RoomyBitArray(torch.zeros(n_words(n), dtype=torch.int32,
                                     device=dev))


# ------------------------------------------------------------ pack codec

def pack_values(vals: torch.Tensor) -> torch.Tensor:
    """(k,) values 0..3 → (ceil(k/16),) int32 words (tail fields padded 0)."""
    k = vals.shape[0]
    v = torch.zeros(n_words(k) * FIELDS_PER_WORD, dtype=torch.int32,
                    device=vals.device)
    v[:k] = vals.to(torch.int32)
    return pack_fields(v.view(-1, FIELDS_PER_WORD))


def unpack_values(data: torch.Tensor) -> torch.Tensor:
    """(w,) int32 words → (w·16,) int32 values 0..3."""
    return unpack_fields(data).reshape(-1)


def get(ba: RoomyBitArray, idx: torch.Tensor) -> torch.Tensor:
    """Batched random read of 2-bit elements."""
    return get_packed(ba.data, idx)


def get_packed(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    idx = idx.to(torch.int64)
    word = data[torch.clamp(idx // FIELDS_PER_WORD, 0, data.shape[0] - 1)]
    return (word >> (2 * (idx % FIELDS_PER_WORD))) & 3


# ------------------------------------------------------- BFS hot paths

def mark_packed(data: torch.Tensor, idx: torch.Tensor,
                valid: torch.Tensor | None = None, *, mark: int = NEXT,
                only_if: int = UNSEEN, impl: str = "auto") -> torch.Tensor:
    """data[idx] ← mark where the element holds only_if — the delayed-mark
    apply (K2).  Safe under duplicate indices; invalid / out-of-range
    indices drop."""
    cap = data.shape[0] * FIELDS_PER_WORD
    idx = idx.to(torch.int32)
    if valid is not None:
        idx = torch.where(valid, idx, cap)
    return K.bitpack_scatter_mark(data, idx.contiguous(), mark=mark,
                                  only_if=only_if, impl=impl)


def rotate_count(data: torch.Tensor, n: int, *, lut: int = ROTATE_LUT,
                 count_val: int = CUR, impl: str = "auto"):
    """Map every element through the 4-entry lut and count elements that
    map to count_val among the first n (K3).  Returns (new_data, count).

    Arrays with tail padding (n < 16·words) require a zero-preserving lut
    (lut[0] == 0): the tail-count correction assumes padding fields hold
    0, which only a zero-preserving lut keeps true across calls."""
    pad = data.shape[0] * FIELDS_PER_WORD - n
    assert pad == 0 or (lut & 3) == 0, \
        "padded arrays need a zero-preserving lut (lut[0] == 0)"
    new, cnt = K.bitpack_lut_count(data, lut, count_val, impl=impl)
    if pad and (lut & 3) == count_val:  # padding fields hold 0 → lut[0]
        cnt = cnt - pad
    return new, cnt


def mark_rotate_count(data: torch.Tensor, idx: torch.Tensor, n: int, *,
                      lut: int = ROTATE_LUT, count_val: int = CUR,
                      mark: int = NEXT, only_if: int = UNSEEN,
                      impl: str = "auto", inplace: bool = False):
    """Fused per-level pass (K1): ``data[idx] ← mark`` where the element
    holds ``only_if``, THEN map every element through the lut and count
    elements mapping to ``count_val`` among the first n.  With
    ``inplace=True`` the words of ``data`` are overwritten.  Returns
    (new_data, count).

    Arrays with tail padding require a zero-preserving lut and mark
    indices within [0, n) — a mark landing in a padding field would break
    the tail-count correction."""
    pad = data.shape[0] * FIELDS_PER_WORD - n
    assert pad == 0 or (lut & 3) == 0, \
        "padded arrays need a zero-preserving lut (lut[0] == 0)"
    new, cnt = K.bitpack_mark_rotate_count(
        data, idx.to(torch.int32).contiguous(), lut, count_val, mark=mark,
        only_if=only_if, impl=impl, inplace=inplace)
    if pad and (lut & 3) == count_val:  # padding fields hold 0 → lut[0]
        cnt = cnt - pad
    return new, cnt


def count_value(ba: RoomyBitArray, value: int, n: int | None = None) -> int:
    """predicateCount for one 2-bit value over the first n elements."""
    n = ba.capacity if n is None else n
    return int((unpack_values(ba.data)[:n] == value).sum())

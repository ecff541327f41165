"""Plain PyTorch versions of the bit-pack kernels (``kernels/csrc/bitpack.cu``).

Twins of ``repro/kernels/ref.py:251-281``.  They are device-agnostic: the
CPU tests run them as the port's only path there, and ``chip_smoke.py``
runs them on CUDA tensors to hold each kernel against them bit for bit.

Packed words are int32 tensors holding the uint32 bits.  Unpacking shifts
arithmetically, which is harmless because every field is masked with 3;
repacking ORs ``field << 2j``, and ``3 << 30`` wraps to the sign bit.
"""
from __future__ import annotations

import torch

FIELDS_PER_WORD = 16


def _shifts(device) -> torch.Tensor:
    return torch.arange(FIELDS_PER_WORD, dtype=torch.int32, device=device) * 2


def unpack_fields(packed: torch.Tensor) -> torch.Tensor:
    """(W,) int32 words → (W, 16) int32 fields 0..3 (field j at bits 2j)."""
    return (packed.unsqueeze(1) >> _shifts(packed.device)) & 3


def pack_fields(fields: torch.Tensor) -> torch.Tensor:
    """(W, 16) fields 0..3 → (W,) int32 words (inverse of unpack_fields)."""
    fields = fields.to(torch.int32)
    out = torch.zeros(fields.shape[0], dtype=torch.int32, device=fields.device)
    for j in range(FIELDS_PER_WORD):
        out |= (fields[:, j] & 3) << (2 * j)
    return out


def bitpack_lut_count_ref(packed: torch.Tensor, lut: int, count_val: int):
    """Map every field through the 4-entry ``lut`` (entry v at bits 2v) and
    count fields that map to ``count_val`` — over ALL W·16 fields.
    Returns (new (W,) int32, count () int32)."""
    f = unpack_fields(packed)
    lut_t = torch.tensor(lut, dtype=torch.int32, device=packed.device)
    nf = (lut_t >> (2 * f)) & 3
    cnt = (nf == count_val).sum().to(torch.int32)
    return pack_fields(nf), cnt


def bitpack_scatter_mark_ref(packed: torch.Tensor, idx: torch.Tensor,
                             mark: int, only_if: int) -> torch.Tensor:
    """``packed[idx] ← mark`` where the field *initially* holds ``only_if``;
    negative and out-of-range indices drop.  Order-independent, so
    duplicates are safe."""
    w = packed.shape[0]
    fields = unpack_fields(packed).reshape(-1)
    idx = idx.to(torch.int64)
    idx = idx[(idx >= 0) & (idx < w * FIELDS_PER_WORD)]
    hit = idx[fields[idx] == only_if]          # gathered before any write
    fields[hit] = mark
    return pack_fields(fields.view(w, FIELDS_PER_WORD))


def bitpack_mark_rotate_count_ref(packed: torch.Tensor, idx: torch.Tensor,
                                  lut: int, count_val: int, mark: int,
                                  only_if: int):
    """The scatter-mark version followed by the lut+count version — the two
    passes the fused kernel does in one launch."""
    marked = bitpack_scatter_mark_ref(packed, idx, mark, only_if)
    return bitpack_lut_count_ref(marked, lut, count_val)

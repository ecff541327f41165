"""Dispatching entry points for the port's kernels (``repro/kernels/ops.py``):
flash attention (``:76-85``) and the bit-pack kernels (``:129-170``).

``impl``:
  * ``"auto"`` goes by the tensor's device: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor.  It never falls back: a
    kernel that fails to build or launch raises.
  * ``"cuda"`` demands the kernel and raises for a CPU tensor.
  * ``"ref"`` runs the plain version on any device (tests, chip_smoke.py).
"""
from __future__ import annotations

import torch

from . import bitpack as _bp
from . import flash_attention as _fa
from . import ref as _ref

IMPLS = ("auto", "cuda", "ref")


def _use_ref(impl: str, packed: torch.Tensor) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "cuda" and packed.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs a CUDA tensor, got one on "
                         f"{packed.device}")
    return impl == "ref"


def bitpack_lut_count(packed, lut, count_val, *, impl="auto"):
    """Map each field through the 4-entry lut and count fields that map to
    ``count_val`` (over ALL W·16 fields — callers with fewer logical
    elements correct for their padding fields)."""
    if _use_ref(impl, packed):
        return _ref.bitpack_lut_count_ref(packed, lut, count_val)
    return _bp.bitpack_lut_count(packed, lut, count_val)


def bitpack_scatter_mark(packed, idx, *, mark=2, only_if=0, impl="auto"):
    """packed[idx]'s field ← mark where it holds only_if; out-of-range
    indices dropped, duplicates safe."""
    if _use_ref(impl, packed):
        return _ref.bitpack_scatter_mark_ref(packed, idx, mark, only_if)
    return _bp.bitpack_scatter_mark(packed, idx, mark=mark, only_if=only_if)


def bitpack_mark_rotate_count(packed, idx, lut, count_val, *, mark=2,
                              only_if=0, impl="auto", inplace=False):
    """Fused scatter-mark + lut-rotate + count — the implicit BFS's whole
    per-level array pass in one launch; the count covers ALL W·16 fields."""
    if _use_ref(impl, packed):
        new, cnt = _ref.bitpack_mark_rotate_count_ref(packed, idx, lut,
                                                      count_val, mark, only_if)
        return (packed.copy_(new) if inplace else new), cnt
    return _bp.bitpack_mark_rotate_count(packed, idx, lut, count_val,
                                         mark=mark, only_if=only_if,
                                         inplace=inplace)


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=None, impl="auto"):
    """q (B, Hq, Sq, D), k, v (B, Hkv, Skv, D) → (B, Hq, Sq, D) in q.dtype:
    causal, sliding-window (``window`` previous positions, self excluded),
    tanh-softcapped, GQA attention."""
    if _use_ref(impl, q):
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  softcap=softcap, scale=scale)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale)

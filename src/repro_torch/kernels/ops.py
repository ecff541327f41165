"""Dispatching entry points for the port's kernels (``repro/kernels/ops.py``):
flash attention with its gradient (``:39-85``), the selective scan
(``:88-113``), the segment scatter-add (``:116-124``), the bit-pack
kernels (``:129-185``) and paged decode
attention (the kernel of ``repro/kernels/paged_decode.py``, which the
reference's ops module leaves out).

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
from . import bucket_scatter as _bs
from . import flash_attention as _fa
from . import flash_attention_bwd as _fab
from . import mamba_scan as _ms
from . import paged_decode as _pd
from . import ref as _ref

IMPLS = ("auto", "cuda", "ref")


def _use_ref(impl: str, packed: torch.Tensor) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "cuda" and packed.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs a CUDA tensor, got one on "
                         f"{packed.device}")
    return impl == "ref"


def bucket_scatter_add(table, idx, payload, *, impl="auto"):
    """``table[idx[i]] += payload[i]`` for every i, out of place, summed in
    float32 (K5): table (N, D), idx (M,) int32, payload (M, D).  Indices in
    [-N, 0) wrap and the rest outside [0, N) drop, as the reference's
    oracle does.  The kernel takes float32 only; the plain version any
    float dtype.  The reference's ``block_m`` sets the TPU kernel's op
    block and has no counterpart here."""
    if _use_ref(impl, table):
        return _ref.bucket_scatter_add_ref(table, idx, payload)
    return _bs.bucket_scatter_add(table, idx, payload)


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


def bitpack_gather2(packed, idx, *, impl="auto"):
    """The 2-bit field at each int32 element index, (M,) int32 in 0..3;
    negative and out-of-range indices give 0 — the serving tier's batched
    lookup's kernel (K4) with a one-entry table.  The reference's
    ``page_words`` / ``block_m`` size the TPU page streamed into VMEM per
    query block; the Hopper kernel reads the words directly and needs
    neither."""
    if _use_ref(impl, packed):
        return _ref.bitpack_gather2_ref(packed, idx)
    return _bp.bitpack_gather2(packed, idx)


def bitpack_gather2_chunked(table, chunk_elems, ranks, out, *, impl="auto"):
    """K4 over a chunk table, one launch a batch: the uint8 code of each
    int64 global rank written into ``out``, from ``table[rank //
    chunk_elems]`` (int32 words, or None to leave the byte as it was);
    ranks outside the table give 0.  The TPU kernel's page table, with the
    oracle's cache chunks as the pages."""
    if _use_ref(impl, ranks):
        return _ref.bitpack_gather2_chunked_ref(table, chunk_elems, ranks,
                                                out)
    return _bp.bitpack_gather2_chunked(table, chunk_elems, ranks, out)


class _FlashAttention(torch.autograd.Function):
    """K6 with its LSE output forward, K7 backward: the counterpart of the
    reference's ``jax.custom_vjp`` (``repro/kernels/ops.py:39-73``).  The
    forward saves (q, k, v, o, lse); the backward returns dq and per-kv-head
    dk, dv.  ``plain`` runs the plain versions of both through the same
    Function; otherwise the kernel wrappers go by the tensor's device."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, plain):
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        if plain:
            o, lse = _ref.attention_lse_ref(q, k, v, **kw)
        else:
            o, lse = _fa.flash_attention(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw, ctx.plain = kw, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = (_ref.flash_attention_bwd_ref if ctx.plain
               else _fab.flash_attention_bwd)
        dq, dk, dv = bwd(q, k, v, o, lse, do.to(o.dtype), **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=None, impl="auto"):
    """q (B, Hq, Sq, D), k, v (B, Hkv, Skv, D) → (B, Hq, Sq, D) in q.dtype:
    causal, sliding-window (``window`` previous positions, self excluded),
    tanh-softcapped, GQA attention.  When a gradient is wanted (grad mode
    on and q, k or v requiring it) the output's gradient flows through K7
    (``_FlashAttention``); otherwise this is K6 without its LSE output, as
    serving runs it."""
    plain = _use_ref(impl, q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, softcap, scale,
                                     plain)
    if plain:
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  softcap=softcap, scale=scale)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           softcap=None, scale=None, impl="auto"):
    """One-token attention over a paged KV cache (K8): q (B, Hq, hd),
    k_pages, v_pages (P, ps, kvh, hd), page_table (B, pps) int32, lengths
    (B,) int32 → (B, Hq, hd) in q.dtype.  The plain version is
    ``ref.paged_decode_attention_ref``."""
    if _use_ref(impl, q):
        return _ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                               page_table, lengths,
                                               softcap=softcap, scale=scale)
    return _pd.paged_decode_attention(q, k_pages, v_pages, page_table,
                                      lengths, softcap=softcap, scale=scale)


def mamba_scan(x, dt, a, b, c, d, *, impl="auto", return_state=False):
    """The selective scan (K9): x, dt (B, L, Di), a (Di, N), b, c
    (B, L, N), d (Di,) → y (B, L, Di) in x.dtype, and with
    ``return_state`` also the final state h_last (B, Di, N) in float32.
    The plain version (``impl="ref"``, or a CPU tensor) is
    ``ref.mamba_scan_plain``: the sequential form with the state, else the
    associative form up to 512 steps, as the reference dispatches."""
    if _use_ref(impl, x):
        return _ref.mamba_scan_plain(x, dt, a, b, c, d, return_state)
    return _ms.mamba_scan(x, dt, a, b, c, d, return_state=return_state)

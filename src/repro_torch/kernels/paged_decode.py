"""Wrapper of the Hopper paged-decode kernel (``csrc/paged_decode.cu``).

Port of ``repro/kernels/paged_decode.py`` (K8 of the kernel table in
PERF.md): one query token per sequence attends over a paged KV cache
through its page table, without gathering the cache.  The wrapper checks
shapes, types and devices, picks the number of splits of each sequence's
pages (flash-decoding: enough blocks to cover the SMs a few times over),
allocates the output and the float32 workspace of the splits' partials,
launches both stages (the splits, then their fixed-order merge) in one
call on the current CUDA stream and books one launch in
``LAUNCHES["paged_decode_attention"]``.  For CPU tensors it returns the
plain version (``ref.paged_decode_attention_ref``); for CUDA tensors it
launches the kernel or raises — there is no fallback.  The kernel has no
backward (decode needs none): a CUDA call whose inputs require a gradient
raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..core import obs
from . import _build
from . import ref as _ref

MAX_HEAD_DIM = 256
MAX_SPLITS = 1024
BLOCKS_PER_SM = 4           # splits cover the SMs this many times over
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches only, never plain-version calls.
LAUNCHES = obs.counters("decode", {"paged_decode_attention": 0})


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_LIB = None
_SMS = {}


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("paged_decode")
        # q, k, v, table, lengths, part_acc, part_ml, out, dtype, B, Hq,
        # kvh, hd, ps, pps, num_pages, splits, q_sb, q_sh, vec, scale,
        # softcap, stage, stream
        lib.roomy_paged_decode.argtypes = [_P] * 8 + [_I] * 9 + [_L, _L, _I,
                                                                _F, _F, _I,
                                                                _P]
        lib.roomy_paged_decode.restype = _I
        lib.roomy_pd_smem_bytes.argtypes = [_I, _I, _I]
        lib.roomy_pd_smem_bytes.restype = _I
        lib.roomy_pd_error_string.argtypes = [_I]
        lib.roomy_pd_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check_inputs(q, k_pages, v_pages, page_table, lengths, softcap) -> None:
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} must be (B, Hq, hd) and "
                         f"k_pages {tuple(k_pages.shape)} (P, ps, kvh, hd)")
    b, hq, hd = q.shape
    _, _, kvh, khd = k_pages.shape
    if v_pages.shape != k_pages.shape or khd != hd:
        raise ValueError(f"k_pages {tuple(k_pages.shape)}, v_pages "
                         f"{tuple(v_pages.shape)} and q {tuple(q.shape)} do "
                         "not share one head_dim and page layout")
    if kvh == 0 or hq % kvh:
        raise ValueError(f"{hq} query heads are not a multiple of {kvh} kv "
                         "heads")
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table {tuple(page_table.shape)} is not "
                         f"(B={b}, pages_per_seq)")
    if lengths.shape != (b,):
        raise ValueError(f"lengths {tuple(lengths.shape)} is not (B={b},)")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"page_table and lengths must be int32, got "
                         f"{page_table.dtype}, {lengths.dtype}")
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype or \
            v_pages.dtype != q.dtype:
        raise ValueError(f"q and the pages must share one of {list(DTYPES)}, "
                         f"got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if any(t.device != q.device for t in (k_pages, v_pages, page_table,
                                          lengths)):
        raise ValueError("q, the pages, page_table and lengths must lie on "
                         "one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap {softcap} must be > 0")


def num_splits(batch: int, kv_heads: int, pages_per_seq: int,
               device) -> int:
    """Splits of each sequence's pages: enough (split, kv head, batch row)
    blocks to cover the card's SMs ``BLOCKS_PER_SM`` times, at most one a
    page.  A function of the shapes only, so the bits of the output do not
    change from call to call."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    want = -(-BLOCKS_PER_SM * _SMS[idx] // max(1, batch * kv_heads))
    return max(1, min(pages_per_seq, want, MAX_SPLITS))


class Partials(NamedTuple):
    """The float32 workspace of the splits: acc (B, kvh, S, g, hd) and
    (m, l) (B, kvh, S, g, 2)."""
    acc: torch.Tensor
    ml: torch.Tensor


def _launch(q, k_pages, v_pages, page_table, lengths, softcap, scale,
            stage: int, parts: Partials | None = None, out=None):
    """Launch stage 1 (the splits' partials), 2 (their merge) or 3 (both)
    and return (out, parts).  Stages 1 and 2 apart are for checks that plant
    a fault between them."""
    b, hq, hd = q.shape
    num_pages, ps, kvh, _ = k_pages.shape
    pps = page_table.shape[1]
    g = hq // kvh
    lib = _lib()
    smem = lib.roomy_pd_smem_bytes(DTYPES[q.dtype], hd, g)
    if not 0 < smem <= 232448:
        raise ValueError(f"K8 takes head_dim <= {MAX_HEAD_DIM} and a group "
                         f"that fits shared memory; got head_dim {hd}, group "
                         f"{g} ({smem} bytes)")
    if parts is None:
        splits = num_splits(b, kvh, pps, q.device)
        parts = Partials(
            torch.empty((b, kvh, splits, g, hd), dtype=torch.float32,
                        device=q.device),
            torch.empty((b, kvh, splits, g, 2), dtype=torch.float32,
                        device=q.device))
    splits = parts.acc.shape[2]
    if out is None:
        out = torch.empty((b, hq, hd), dtype=q.dtype, device=q.device)
    if b == 0 or hq == 0:
        return out, parts
    esz = q.element_size()
    vec = int(hd * esz % 16 == 0 and k_pages.data_ptr() % 16 == 0
              and v_pages.data_ptr() % 16 == 0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.roomy_paged_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), parts.acc.data_ptr(),
            parts.ml.data_ptr(), out.data_ptr(), DTYPES[q.dtype], b, hq, kvh,
            hd, ps, pps, num_pages, splits, q.stride(0), q.stride(1), vec,
            float(scale), 0.0 if softcap is None else float(softcap), stage,
            stream)
    if code:
        raise RuntimeError(f"roomy_paged_decode: CUDA error {code}: "
                           f"{lib.roomy_pd_error_string(code).decode()}")
    return out, parts


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, *,
                           softcap: float | None = None,
                           scale: float | None = None) -> torch.Tensor:
    """K8: q (B, Hq, hd), k_pages, v_pages (P, ps, kvh, hd) contiguous,
    page_table (B, pps) int32 physical page ids, lengths (B,) int32 →
    (B, Hq, hd) in q.dtype (float32 or bfloat16, hd <= 256).  Positions
    past min(length, pps·ps) are masked and their table entries never
    read; a row of length 0 gives 0."""
    check_inputs(q, k_pages, v_pages, page_table, lengths, softcap)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _ref.paged_decode_attention_ref(
            q, k_pages, v_pages, page_table, lengths, softcap=softcap,
            scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (q, k_pages, v_pages)):
        raise NotImplementedError("K8 (paged_decode_attention) has no "
                                  "backward: it serves decode only")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        # a copy of a whole cache would cost more than the kernel
        raise ValueError("k_pages and v_pages must be contiguous")
    q = q if q.stride(-1) == 1 else q.contiguous()
    page_table, lengths = page_table.contiguous(), lengths.contiguous()
    out, _ = _launch(q, k_pages, v_pages, page_table, lengths, softcap,
                     scale, stage=3)
    LAUNCHES["paged_decode_attention"] += 1
    return out

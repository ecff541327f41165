"""Wrapper of the Hopper paged-decode kernel (``csrc/paged_decode.cu``).

Port of ``repro/kernels/paged_decode.py`` (K8 of the kernel table in
PERF.md): one query token per sequence attends over a paged KV cache
through its page table, without gathering the cache.  The wrapper checks
shapes, types and devices, picks the route and the number of splits of
each sequence's pages (flash-decoding), allocates the output and the
float32 workspace of the splits' partials, launches on the current CUDA
stream and books one launch in ``LAUNCHES["paged_decode_attention"]`` and
one in ``ROUTE_LAUNCHES`` under its route.  For CPU tensors it returns the
plain version (``ref.paged_decode_attention_ref``); for CUDA tensors it
launches the kernel or raises — there is no fallback.  The kernel has no
backward (decode needs none): a CUDA call whose inputs require a gradient
raises.

Two routes, chosen by ``route`` before launch from dtype, head dim, page
size, strides and alignment alone:

* ``"tma"``: bfloat16 at head dims 64, 128 and 256 (minicpm-2b,
  nemotron-4-15b and granite-34b, gemma2-2b) with pages of a multiple of
  ``TMA_TILE`` tokens (``lm.PAGE_SIZE`` = 128 among them) and 16-byte
  aligned pools: ``pd_hopper_kernel``, a TMA ring of K/V tiles that
  follows the page table, mma.sync products, and the splits' merge in the
  same launch.  The wrapper passes each pool as a 4-D tensor map
  (``tma_geometry``) and a zeroed ticket counter per (batch row, kv head,
  m-tile) that the kernel leaves zeroed.
* ``"classic"``: everything else (float32, the smoke configs' head dims,
  pages of 8 or 16 tokens): ``partial_kernel`` then ``merge_kernel``.

A route's kernel that fails to build or launch raises; neither route
stands in for the other.
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
BLOCKS_PER_SM = 4           # classic: splits cover the SMs this many times
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: The TMA route: head dims, tokens a tile (a box's rows: a page must be a
#: whole number of them), columns of a box (one 128-byte swizzle row),
#: query rows a block (one m16 tile of the group), and the split plan's
#: limits (``tma_splits``).
TMA_HEAD_DIMS = (64, 128, 256)
TMA_TILE = 64
TMA_BOX_COLS = 64
TMA_ROWS = 16
TMA_MAX_SPLITS = 512
TMA_MAX_PAGES = 16

#: Kernel launches only, never plain-version calls.
LAUNCHES = obs.counters("decode", {"paged_decode_attention": 0})

#: The same launches by route.
ROUTE_LAUNCHES = obs.counters("decode_route", {"tma": 0, "classic": 0})


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTE_LAUNCHES):
        for k in counts:
            counts[k] = 0


_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_LIB = None
_SMS = {}
_SLOTS = {}
_COUNTERS = {}


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
        # q, k, v, table, lengths, part_acc, part_ml, counters, out, B, Hq,
        # kvh, hd, ps, pps, num_pages, splits, q_sb, q_sh, maps, scale,
        # softcap, stage, stream
        lib.roomy_paged_decode_tma.argtypes = [_P] * 9 + [_I] * 8 + [
            _L, _L, _P, _F, _F, _I, _P]
        lib.roomy_paged_decode_tma.restype = _I
        lib.roomy_pd_tma_smem.argtypes = [_I]
        lib.roomy_pd_tma_smem.restype = _I
        lib.roomy_pd_tma_blocks_per_sm.argtypes = [_I]
        lib.roomy_pd_tma_blocks_per_sm.restype = _I
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


def _index(device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def _sms(device) -> int:
    idx = _index(device)
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def num_splits(batch: int, kv_heads: int, pages_per_seq: int,
               device) -> int:
    """The classic route's splits of each sequence's pages: enough (split,
    kv head, batch row) blocks to cover the card's SMs ``BLOCKS_PER_SM``
    times, at most one a page.  A function of the shapes only, so the bits
    of the output do not change from call to call."""
    want = -(-BLOCKS_PER_SM * _sms(device) // max(1, batch * kv_heads))
    return max(1, min(pages_per_seq, want, MAX_SPLITS))


def route(q, k_pages, v_pages) -> str:
    """The kernel that takes a call (inputs as ``check_inputs`` passes
    them): ``"tma"`` for bfloat16 at a head dim in ``TMA_HEAD_DIMS`` with
    pages of a whole number of ``TMA_TILE`` tokens, both pools contiguous
    and 16-byte aligned and not empty; ``"classic"`` otherwise."""
    if q.dtype != torch.bfloat16 or q.shape[-1] not in TMA_HEAD_DIMS:
        return "classic"
    if k_pages.shape[1] % TMA_TILE or k_pages.numel() == 0:
        return "classic"
    ready = all(t.is_contiguous() and t.data_ptr() % 16 == 0
                for t in (k_pages, v_pages))
    return "tma" if ready else "classic"


def tma_geometry(pages: torch.Tensor) -> tuple:
    """The 4-D TMA map of a contiguous (P, ps, kvh, hd) pool, as 11 ints:
    dims innermost first (hd, kvh, ps, P), the byte strides of kvh, ps and
    P, and the box (``TMA_BOX_COLS`` columns, 1 kv head, ``TMA_TILE``
    tokens, 1 page).  A box never leaves its kv head or page: it is read
    at (column, head, first token of the tile, physical page)."""
    num_pages, ps, kvh, hd = pages.shape
    es = pages.element_size()
    return (hd, kvh, ps, num_pages, hd * es, kvh * hd * es,
            ps * kvh * hd * es, TMA_BOX_COLS, 1, TMA_TILE, 1)


def tma_splits(batch: int, kv_heads: int, group: int, pages_per_seq: int,
               page_size: int, slots: int) -> int:
    """The TMA route's splits of each sequence's pages, from the shapes and
    the card's ``slots`` (SMs times the blocks of the kernel an SM holds)
    alone, so the bits of the output do not change from call to call: one
    wave of (split, m-tile, kv head, batch row) blocks; more splits where
    a split would take more than ``TMA_MAX_PAGES`` pages (a long cache or
    a batch of ragged lengths spreads over waves); at most
    sqrt(pps·ps / 16), which keeps the last block's merge of the splits'
    partials small against the split's own reads."""
    blocks = max(1, batch * kv_heads * -(-group // TMA_ROWS))
    fill = max(1, slots // blocks)
    spread = -(-pages_per_seq // TMA_MAX_PAGES)
    merge = max(1, math.isqrt(pages_per_seq * page_size // 16))
    return max(1, min(pages_per_seq, max(fill, spread), merge,
                      TMA_MAX_SPLITS))


def _tma_slots(device, hd: int) -> int:
    """The TMA route's blocks the card holds at once at head dim ``hd``:
    its SMs times the kernel's occupancy, read once a device."""
    idx = _index(device)
    if (idx, hd) not in _SLOTS:
        with torch.cuda.device(idx):
            per_sm = _lib().roomy_pd_tma_blocks_per_sm(hd)
        if per_sm <= 0:
            raise RuntimeError(f"roomy_pd_tma_blocks_per_sm({hd}) = {per_sm}")
        _SLOTS[idx, hd] = per_sm * _sms(device)
    return _SLOTS[idx, hd]


def _counters(device, stream: int, n: int) -> torch.Tensor:
    """A zeroed int32 buffer of at least n tickets for launches on
    ``stream`` (a raw stream handle) of ``device``; each launch leaves the
    ones it took at 0 again.  One buffer a (device, stream): launches on
    one stream run in order, while two streams' launches may overlap and
    must not count into the same tickets."""
    key = (torch.device(device), stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                           device=device)
    return buf


class Partials(NamedTuple):
    """The float32 workspace of the splits: acc (B, kvh, S, g, hd) and
    (m, l) (B, kvh, S, g, 2)."""
    acc: torch.Tensor
    ml: torch.Tensor


def _launch(q, k_pages, v_pages, page_table, lengths, softcap, scale,
            stage: int, parts: Partials | None = None, out=None, path=None):
    """Launch stage 1 (the splits' partials), 2 (their merge) or 3 (both)
    on ``path`` (``route``'s choice when None) and return (out, parts).
    Stages 1 and 2 apart are for checks that plant a fault between them."""
    b, hq, hd = q.shape
    num_pages, ps, kvh, _ = k_pages.shape
    pps = page_table.shape[1]
    g = hq // kvh
    path = path or route(q, k_pages, v_pages)
    lib = _lib()
    if path == "classic":
        smem = lib.roomy_pd_smem_bytes(DTYPES[q.dtype], hd, g)
        if not 0 < smem <= 232448:
            raise ValueError(f"K8 takes head_dim <= {MAX_HEAD_DIM} and a "
                             f"group that fits shared memory; got head_dim "
                             f"{hd}, group {g} ({smem} bytes)")
    if parts is None:
        splits = (num_splits(b, kvh, pps, q.device) if path == "classic"
                  else tma_splits(b, kvh, g, pps, ps,
                                  _tma_slots(q.device, hd)))
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
    sc = 0.0 if softcap is None else float(softcap)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if path == "tma":
            maps = (ctypes.c_longlong * 22)(*tma_geometry(k_pages),
                                            *tma_geometry(v_pages))
            cnt = _counters(q.device, stream, b * kvh * -(-g // TMA_ROWS))
            name = "roomy_paged_decode_tma"
            code = lib.roomy_paged_decode_tma(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                page_table.data_ptr(), lengths.data_ptr(),
                parts.acc.data_ptr(), parts.ml.data_ptr(), cnt.data_ptr(),
                out.data_ptr(), b, hq, kvh, hd, ps, pps, num_pages, splits,
                q.stride(0), q.stride(1), ctypes.cast(maps, ctypes.c_void_p),
                float(scale), sc, stage, stream)
        else:
            esz = q.element_size()
            vec = int(hd * esz % 16 == 0 and k_pages.data_ptr() % 16 == 0
                      and v_pages.data_ptr() % 16 == 0)
            name = "roomy_paged_decode"
            code = lib.roomy_paged_decode(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                page_table.data_ptr(), lengths.data_ptr(),
                parts.acc.data_ptr(), parts.ml.data_ptr(), out.data_ptr(),
                DTYPES[q.dtype], b, hq, kvh, hd, ps, pps, num_pages, splits,
                q.stride(0), q.stride(1), vec, float(scale), sc, stage,
                stream)
    if code:
        raise RuntimeError(f"{name}: CUDA error {code}: "
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
    path = route(q, k_pages, v_pages)
    out, _ = _launch(q, k_pages, v_pages, page_table, lengths, softcap,
                     scale, stage=3, path=path)
    LAUNCHES["paged_decode_attention"] += 1
    ROUTE_LAUNCHES[path] += 1
    return out

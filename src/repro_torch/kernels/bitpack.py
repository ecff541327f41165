"""Wrappers of the Hopper bit-pack kernels (``csrc/bitpack.cu``).

Port of ``repro/kernels/bitpack.py`` (K1–K4 of the kernel table in
PERF.md).  Each wrapper checks dtype, device, contiguity and shape,
allocates its outputs (and K1's and K2's workspace) with ``torch.empty``,
launches on the current CUDA stream and books one launch in ``LAUNCHES``.
For a tensor on the CPU it returns the plain version (``ref.py``) instead;
for a CUDA tensor it launches the kernel or raises — there is no fallback.

K1 and K2 have two routes, chosen by ``route`` from (W, M) alone:
``"binned"`` sorts the marks by tile of ``TILE_WORDS`` words and applies
each tile's marks in shared memory (``bin_plan`` sizes its workspace);
``"atomic"`` marks each field with a global atomic where it lands.
``ROUTE_LAUNCHES`` books each launch under its route.

Packed words are int32 tensors holding the uint32 bits; the kernels read
the same storage as ``uint32_t*``.  Element indices are int32, so a packed
array holds fewer than 2³¹ fields (16·W < 2³¹, pancake n ≤ 12); K4's
chunked form takes int64 global ranks over a table of such arrays.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core import obs
from . import _build
from . import ref as _ref
from .ref import FIELDS_PER_WORD

MAX_FIELDS = 1 << 31
#: Words a tile of the binned route holds (``kTileWords`` in the source):
#: 65,536 fields, so a target's offset in its tile fits a uint16.
TILE_WORDS = _ref.BIN_TILE_WORDS
#: The binned route's count and scatter passes: a block of 1024 threads an
#: SM at most, and none for fewer than this many targets.
BIN_TARGETS_PER_BLOCK = 1 << 14
#: Bin positions are uint32 in the kernels.
MAX_TARGETS = (1 << 32) - 1
#: The most tiles the binned route's scatter holds in shared memory
#: (``kMaxTiles``): 102M words; wider arrays take the atomic route.
BIN_MAX_TILES = 24927

#: Kernel launches per wrapper (launches only, never plain-version calls).
LAUNCHES = obs.counters("kernels", {"mark_rotate_count": 0,
                                    "scatter_mark": 0, "lut_count": 0,
                                    "gather2": 0})

#: K1's and K2's launches by route.
ROUTE_LAUNCHES = obs.counters("bitpack_route", {"binned": 0, "atomic": 0})


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTE_LAUNCHES):
        for k in counts:
            counts[k] = 0


def make_lut(table) -> int:
    """Encode a 4-entry value map [new0, new1, new2, new3] into one integer:
    entry v occupies bits [2v, 2v+2)."""
    assert len(table) == 4 and all(0 <= v <= 3 for v in table)
    return sum(int(v) << (2 * i) for i, v in enumerate(table))


_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    # in, out, n_words, lut, count_val, count, stream
    "roomy_lut_count": [_P, _P, _I64, _I32, _I32, _P, _P],
    # in, out, n_words, idx, m, mark, only_if, stream
    "roomy_scatter_mark": [_P, _P, _I64, _P, _I64, _I32, _I32, _P],
    # in, out, n_words, idx, m, mark, only_if, lut, count_val, count, stream
    "roomy_mark_rotate_count": [_P, _P, _I64, _P, _I64, _I32, _I32, _I32,
                                _I32, _P, _P],
    # in, out, n_words, idx, m, mark, only_if, blocks, per_block, counts,
    # tile_total, tile_start, bins, stream
    "roomy_scatter_mark_binned": [_P, _P, _I64, _P, _I64, _I32, _I32, _I32,
                                  _I64, _P, _P, _P, _P, _P],
    # in, out, n_words, idx, m, mark, only_if, lut, count_val, count,
    # blocks, per_block, counts, tile_total, tile_start, bins, stream
    "roomy_mark_rotate_count_binned": [_P, _P, _I64, _P, _I64, _I32, _I32,
                                       _I32, _I32, _P, _I32, _I64, _P, _P,
                                       _P, _P, _P],
    # words, n_words, idx, m, out, stream
    "roomy_gather2": [_P, _I64, _P, _I64, _P, _P],
    # table, n_chunks, chunk_elems, ranks, m, out, stream
    "roomy_gather2_chunked": [_P, _I32, _I64, _P, _I64, _P, _P],
}
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("bitpack")
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.roomy_error_string.argtypes = [ctypes.c_int]
        lib.roomy_error_string.restype = ctypes.c_char_p
        for name in ("roomy_bin_tile_words", "roomy_bin_tile_smem",
                     "roomy_bin_max_tiles", "roomy_gather2_smem_chunks"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        got = (lib.roomy_bin_tile_words(), lib.roomy_bin_max_tiles())
        if got != (TILE_WORDS, BIN_MAX_TILES):
            raise RuntimeError(f"csrc/bitpack.cu tiles {got[0]} words, at "
                               f"most {got[1]}; the wrapper {TILE_WORDS}, "
                               f"{BIN_MAX_TILES}")
        _LIB = lib
    return _LIB


def _launch(name: str, packed: torch.Tensor, *args) -> None:
    lib = _lib()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        code = getattr(lib, name)(*args, stream)
    if code:
        raise RuntimeError(f"{name}: CUDA error {code}: "
                           f"{lib.roomy_error_string(code).decode()}")


def _on_card(packed: torch.Tensor, idx: torch.Tensor | None = None) -> bool:
    """Validate the arguments; True for CUDA tensors, False for CPU ones."""
    if packed.dtype != torch.int32 or packed.dim() != 1:
        raise TypeError(f"packed words must be a 1-D int32 tensor, got "
                        f"{packed.dtype} of shape {tuple(packed.shape)}")
    if not packed.is_contiguous():
        raise ValueError("packed words must be contiguous")
    if packed.shape[0] * FIELDS_PER_WORD >= MAX_FIELDS:
        raise ValueError(f"{packed.shape[0]} words hold 2^31 fields or more; "
                         "int32 element indices cannot address them")
    if idx is not None:
        if idx.dtype != torch.int32 or idx.dim() != 1:
            raise TypeError(f"indices must be a 1-D int32 tensor, got "
                            f"{idx.dtype} of shape {tuple(idx.shape)}")
        if not idx.is_contiguous():
            raise ValueError("indices must be contiguous")
        if idx.device != packed.device:
            raise ValueError(f"indices on {idx.device}, words on "
                             f"{packed.device}")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {packed.device}")
    return packed.device.type == "cuda"


def _check_values(*fields: int, lut: int = 0) -> None:
    if not 0 <= lut < 256:
        raise ValueError(f"lut {lut} is not a 4-entry 2-bit map")
    for v in fields:
        if not 0 <= v <= 3:
            raise ValueError(f"field value {v} outside 0..3")


def bitpack_lut_count(packed: torch.Tensor, lut: int, count_val: int):
    """K3: map every field through ``lut`` and count fields that map to
    ``count_val`` over all W·16 fields.  Returns (new (W,) int32, count ()
    int32)."""
    _check_values(count_val, lut=lut)
    if not _on_card(packed):
        return _ref.bitpack_lut_count_ref(packed, lut, count_val)
    out = torch.empty_like(packed)
    cnt = torch.empty((), dtype=torch.int32, device=packed.device)
    _launch("roomy_lut_count", packed, packed.data_ptr(), out.data_ptr(),
            packed.shape[0], lut, count_val, cnt.data_ptr())
    obs.add(LAUNCHES, "lut_count", 1)
    return out, cnt


def route(n_words: int, m: int) -> str:
    """The route of a K1 or K2 call over ``n_words`` words and ``m``
    targets: ``"binned"`` for at least half as many targets as words,
    where its passes over the targets cost less than the atomic route's
    marks (at pancake n = 12 the two cross between 0.2 and 1.1 targets a
    word), and for no more tiles than its scatter holds; ``"atomic"``
    otherwise."""
    if 2 * m < n_words or -(-n_words // TILE_WORDS) > BIN_MAX_TILES:
        return "atomic"
    return "binned"


class BinPlan(NamedTuple):
    """The binned route's launch and workspace: ``blocks`` count and
    scatter blocks, each over ``per_block`` targets (a multiple of 4); the
    workspace's byte offsets of counts (n_tiles x blocks uint32),
    tile_total (n_tiles), tile_start (n_tiles + 1) and the bins (m uint16),
    and its size."""
    n_tiles: int
    blocks: int
    per_block: int
    counts: int
    tile_total: int
    tile_start: int
    bins: int
    nbytes: int


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def bin_plan(n_words: int, m: int, sms: int) -> BinPlan:
    """The plan of a binned call over ``n_words`` words and ``m`` targets on
    a card of ``sms`` SMs: one block an SM at most (fewer partly written
    bin sectors held in L2 at once), none for fewer than
    ``BIN_TARGETS_PER_BLOCK`` targets."""
    n_tiles = -(-n_words // TILE_WORDS)
    blocks = max(1, min(sms, -(-m // BIN_TARGETS_PER_BLOCK)))
    per_block = -(-(-(-m // blocks)) // 4) * 4
    counts = 0
    tile_total = counts + _align16(4 * n_tiles * blocks)
    tile_start = tile_total + _align16(4 * n_tiles)
    bins = tile_start + _align16(4 * (n_tiles + 1))
    return BinPlan(n_tiles, blocks, per_block, counts, tile_total,
                   tile_start, bins, bins + _align16(2 * m))


_SMS = {}


def _sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _mark(packed, idx, out, mark, only_if, lut=None, count_val=None,
          path=None):
    """Launch K1 (``lut`` given: mark, rotate, count into ``out``) or K2
    (mark into ``out``) on ``path`` (``route``'s choice when None); returns
    K1's count, or None.  Books no launch: the wrappers do."""
    w, m = packed.shape[0], idx.shape[0]
    if m > MAX_TARGETS:
        raise ValueError(f"{m} targets; K1 and K2 take at most "
                         f"{MAX_TARGETS}")
    path = path or route(w, m)
    cnt = None
    if lut is not None:
        cnt = torch.empty((), dtype=torch.int32, device=packed.device)
    if path == "atomic":
        if lut is None:
            _launch("roomy_scatter_mark", packed, packed.data_ptr(),
                    out.data_ptr(), w, idx.data_ptr(), m, mark, only_if)
        else:
            _launch("roomy_mark_rotate_count", packed, packed.data_ptr(),
                    out.data_ptr(), w, idx.data_ptr(), m, mark, only_if,
                    lut, count_val, cnt.data_ptr())
        return cnt
    if path != "binned":
        raise ValueError(f"unknown route {path!r}")
    plan = bin_plan(w, m, _sms(packed.device))
    work = torch.empty(plan.nbytes, dtype=torch.uint8, device=packed.device)
    base = work.data_ptr()
    tail = (plan.blocks, plan.per_block, base + plan.counts,
            base + plan.tile_total, base + plan.tile_start, base + plan.bins)
    if lut is None:
        _launch("roomy_scatter_mark_binned", packed, packed.data_ptr(),
                out.data_ptr(), w, idx.data_ptr(), m, mark, only_if, *tail)
    else:
        _launch("roomy_mark_rotate_count_binned", packed, packed.data_ptr(),
                out.data_ptr(), w, idx.data_ptr(), m, mark, only_if, lut,
                count_val, cnt.data_ptr(), *tail)
    return cnt


def bitpack_scatter_mark(packed: torch.Tensor, idx: torch.Tensor, *,
                         mark: int = 2, only_if: int = 0) -> torch.Tensor:
    """K2: ``packed[idx] ← mark`` where the field holds ``only_if``;
    negative and ≥ 16·W indices drop, duplicates are safe.  Out of place."""
    _check_values(mark, only_if)
    if not _on_card(packed, idx):
        return _ref.bitpack_scatter_mark_ref(packed, idx, mark, only_if)
    out = torch.empty_like(packed)
    path = route(packed.shape[0], idx.shape[0])
    _mark(packed, idx, out, mark, only_if, path=path)
    obs.add(LAUNCHES, "scatter_mark", 1)
    obs.add(ROUTE_LAUNCHES, path, 1)
    return out


def bitpack_mark_rotate_count(packed: torch.Tensor, idx: torch.Tensor,
                              lut: int, count_val: int, *, mark: int = 2,
                              only_if: int = 0, inplace: bool = False):
    """K1: the scatter-mark of K2, then the rotate+count of K3, in one
    pass over the words.  With ``inplace=True`` the result is written over
    ``packed`` (one read and one write of the words) and ``packed`` is
    returned.  Returns (new (W,) int32, count () int32)."""
    _check_values(count_val, mark, only_if, lut=lut)
    if not _on_card(packed, idx):
        new, cnt = _ref.bitpack_mark_rotate_count_ref(packed, idx, lut,
                                                      count_val, mark, only_if)
        return (packed.copy_(new) if inplace else new), cnt
    out = packed if inplace else torch.empty_like(packed)
    path = route(packed.shape[0], idx.shape[0])
    cnt = _mark(packed, idx, out, mark, only_if, lut, count_val, path=path)
    obs.add(LAUNCHES, "mark_rotate_count", 1)
    obs.add(ROUTE_LAUNCHES, path, 1)
    return out, cnt


def bitpack_gather2(packed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K4 over one flat array: the 2-bit field at each element index, as
    (M,) int32 in 0..3.  Negative and ≥ 16·W indices give 0; duplicates
    are fine.  An empty index tensor gives an empty result and launches
    nothing.  The kernel is the chunked one's, with a one-entry table."""
    if not _on_card(packed, idx):
        return _ref.bitpack_gather2_ref(packed, idx)
    out = torch.empty(idx.shape[0], dtype=torch.int32, device=packed.device)
    if idx.shape[0] == 0:
        return out
    _launch("roomy_gather2", packed, packed.data_ptr(), packed.shape[0],
            idx.data_ptr(), idx.shape[0], out.data_ptr())
    obs.add(LAUNCHES, "gather2", 1)
    return out


def _check_chunked(table, chunk_elems: int, ranks: torch.Tensor,
                   out: torch.Tensor) -> bool:
    """Validate K4's chunked arguments; True for CUDA tensors."""
    if ranks.dtype != torch.int64 or ranks.dim() != 1:
        raise TypeError(f"ranks must be a 1-D int64 tensor, got "
                        f"{ranks.dtype} of shape {tuple(ranks.shape)}")
    if out.dtype != torch.uint8 or out.shape != ranks.shape:
        raise TypeError(f"out must be a uint8 tensor of the ranks' shape "
                        f"{tuple(ranks.shape)}, got {out.dtype} of shape "
                        f"{tuple(out.shape)}")
    if not (ranks.is_contiguous() and out.is_contiguous()):
        raise ValueError("ranks and out must be contiguous")
    if out.device != ranks.device:
        raise ValueError(f"out on {out.device}, ranks on {ranks.device}")
    if not 1 <= len(table) < 1 << 31:
        raise ValueError(f"a table of {len(table)} chunks")
    if not 1 <= chunk_elems < 1 << 62:
        raise ValueError(f"chunk_elems {chunk_elems} outside [1, 2^62)")
    for c, words in enumerate(table):
        if words is None:
            continue
        if words.dtype != torch.int32 or words.dim() != 1:
            raise TypeError(f"chunk {c}: words must be a 1-D int32 tensor, "
                            f"got {words.dtype} of shape "
                            f"{tuple(words.shape)}")
        if not words.is_contiguous():
            raise ValueError(f"chunk {c}: words must be contiguous")
        if words.device != ranks.device:
            raise ValueError(f"chunk {c} on {words.device}, ranks on "
                             f"{ranks.device}")
    if ranks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ranks.device}")
    return ranks.device.type == "cuda"


def bitpack_gather2_chunked(table, chunk_elems: int, ranks: torch.Tensor,
                            out: torch.Tensor) -> torch.Tensor:
    """K4 over a chunk table, one launch a batch: ``table[c]`` holds the
    int32 words of the ``chunk_elems`` fields from ``c·chunk_elems`` on, or
    None for a chunk another call serves.  Writes the (M,) uint8 code of
    each int64 global rank into ``out`` in place and returns it; a rank in
    a None chunk leaves its byte as it was, a rank below 0 or past the last
    chunk, or past its chunk's words, gives 0.  An empty batch launches
    nothing."""
    chunk_elems = int(chunk_elems)
    if not _check_chunked(table, chunk_elems, ranks, out):
        return _ref.bitpack_gather2_chunked_ref(table, chunk_elems, ranks,
                                                out)
    if ranks.shape[0] == 0:
        return out
    launch_gather2_chunked(chunk_table(table, ranks.device), chunk_elems,
                           ranks, out)
    obs.add(LAUNCHES, "gather2", 1)
    return out


def chunk_table(table, device: torch.device) -> torch.Tensor:
    """K4's device table: an int64 (word pointer, n_words) row a chunk,
    (0, -1) for None.  It travels from a pinned tensor made for this call:
    the caching host allocator holds that block until the non-blocking copy
    has run, so no later call rewrites it while the copy is in flight."""
    entries = [(0, -1) if w is None else (w.data_ptr(), w.shape[0])
               for w in table]
    staged = torch.tensor(entries, dtype=torch.int64, pin_memory=True)
    return staged.to(device, non_blocking=True)


def launch_gather2_chunked(dev_table: torch.Tensor, chunk_elems: int,
                           ranks: torch.Tensor, out: torch.Tensor) -> None:
    """Launch K4 over a device table made by ``chunk_table``; checks
    nothing and books no launch (``bitpack_gather2_chunked`` does both)."""
    _launch("roomy_gather2_chunked", ranks, dev_table.data_ptr(),
            dev_table.shape[0], chunk_elems, ranks.data_ptr(), ranks.shape[0],
            out.data_ptr())

"""Wrapper of the Hopper segment scatter-add kernel (``csrc/bucket_scatter.cu``).

Port of ``repro/kernels/bucket_scatter.py`` (K5 of the kernel table in
PERF.md): ``out = table; out[idx[i]] += payload[i]`` in float32, the apply
phase of a Roomy sync.  Indices follow the oracle's contract
(``ref.bucket_scatter_add_ref``): [-N, 0) wraps, below -N and >= N drop.

For a table on the CPU the wrapper returns the plain version; for a CUDA
table it launches the kernel or raises — there is no fallback.  The kernel
takes float32 tables and payloads only (the sync's route sends nothing
else).  It reads a table or a payload whose rows are strided (column
stride 1) in place, and books one launch in ``LAUNCHES`` per call, however
many CUDA kernels the call runs; an empty ``idx`` gives a copy of the
table and launches nothing.

The kernel sums each row's ops in the fixed order of
``ref.bucket_scatter_add_ordered`` (chunks of ``CHUNK`` ops, each left to
right, then the chunks in order), so its result has the same bits on every
run; ``geometry`` sizes its row tiles, its binning passes and its
scratch, which this wrapper allocates.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core import obs
from . import _build
from . import ref as _ref

#: Kernel launches (launches only, never plain-version calls).
LAUNCHES = obs.counters("scatter", {"bucket_scatter_add": 0})


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P, _I64 = ctypes.c_void_p, ctypes.c_longlong
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("bucket_scatter")
        # table, table_stride, out, n, d, idx, m, pay, pay_stride, vec,
        # tile_rows, warps, passes, bits, ws, ws_ints, scratch,
        # scratch_floats, stream
        lib.roomy_bucket_scatter_add.argtypes = [
            _P, _I64, _P, _I64, _I64, _P, _I64, _P, _I64, _I64, _I64, _I64,
            _I64, _I64, _P, _I64, _P, _I64, _P]
        lib.roomy_bucket_scatter_add.restype = ctypes.c_int
        lib.roomy_scatter_error_string.argtypes = [ctypes.c_int]
        lib.roomy_scatter_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


#: A row's ops, in op order, are summed in chunks of this many (G).
CHUNK = _ref.K5_CHUNK
#: Vectors a row tile holds at most (passes of 4 vectors a thread of 4
#: floats, or 8 single floats, 256 threads).
TILE_VECS = 8192
#: Rows a tile holds at most.
MAX_TILE_ROWS = 4096
#: Ops a binning warp walks, and the most warps the binning takes.
OPS_PER_WARP = 256
MAX_WARPS = 2048
#: Ops a warp may walk where fewer warps keep the binning to one pass.
ONE_PASS_OPS = 8192
#: Entries of the binned route's (digit, warp) count matrix at most.
MAT_BUDGET = 1 << 22
#: Ints the kernel's header takes (route flag, each route's tasks, the
#: binned route's kept ops).
HEADER_INTS = 4
#: Ints a task takes (first position, the row's end).
TASK_INTS = 2
#: Matrix entries a scan step takes.
SCAN_CHUNK = 2048


@functools.lru_cache(maxsize=64)
def geometry(n: int, d: int, m: int, vec: int) -> dict:
    """K5's geometry for an (n, d) table and m ops, read ``vec`` floats at
    a time (4 or 1): rows a tile (``TILE_VECS`` vectors, so D = 1 takes
    4096 rows a tile, D = 1536 twenty-one and D = 2304 fourteen), tiles,
    and the binned route's passes.  It bins with one warp per
    ``OPS_PER_WARP`` ops (at most ``MAX_WARPS``) and one pass, the row
    itself the digit, while the (row, warp) matrix stays within
    ``MAT_BUDGET`` entries, with fewer warps where each then walks at
    most ``ONE_PASS_OPS`` ops; else in ``passes`` passes of ``bits`` bits
    of the row each, the matrix 2^bits x warps.  Then the task list's
    capacity (a row of two ops or more, m // 2 at most, and a long row's
    chunks, two a window of ``CHUNK`` positions), and the ints and floats
    of scratch the wrapper allocates.  The int workspace is laid out as
    ``csrc/bucket_scatter.cu``'s ``carve``: the header, the tile starts (a
    tile and one), the matrix, the scan's step sums, the bins (m) and the
    tasks (whose space also holds the passes' second list); the floats
    are the chunk partials then the heads (a row of d each a ``CHUNK``
    window).  The kernel checks both counts.  Cached: callers read the
    dict and never change it."""
    dv = d // vec
    tile_rows = max(1, min(MAX_TILE_ROWS, TILE_VECS // dv))
    n_tiles = -(-n // tile_rows)
    warps = max(1, min(-(-m // OPS_PER_WARP), MAX_WARPS))
    fewer = MAT_BUDGET // n
    if n * warps > MAT_BUDGET and fewer >= 1 and -(-m // fewer) <= \
            ONE_PASS_OPS:
        warps = fewer
    if n * warps <= MAT_BUDGET:
        passes, bits, mat = 1, max(1, (n - 1).bit_length()), n * warps
    else:
        row_bits = (n - 1).bit_length()
        passes = -(-row_bits // ((MAT_BUDGET // warps).bit_length() - 1))
        bits = -(-row_bits // passes)
        mat = warps << bits
    windows = -(-m // CHUNK)
    tasks = m // 2 + 2 * windows
    steps = -(-mat // SCAN_CHUNK)
    ints = (HEADER_INTS + n_tiles + 1 + mat + steps + m
            + TASK_INTS * tasks)
    return {"vec": vec, "tile_rows": tile_rows, "n_tiles": n_tiles,
            "warps": warps, "passes": passes, "bits": bits, "mat": mat,
            "tasks": tasks, "scan_steps": steps, "ws_ints": ints,
            "scratch_floats": 2 * windows * d}


def vector_width(table: torch.Tensor, payload: torch.Tensor) -> int:
    """4 where D, both row strides and both base addresses allow 16-byte
    access, else 1."""
    ok = (table.shape[1] % 4 == 0 and table.stride(0) % 4 == 0
          and payload.stride(0) % 4 == 0 and table.data_ptr() % 16 == 0
          and payload.data_ptr() % 16 == 0)
    return 4 if ok else 1


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its rows are strided with unit column stride,
    else a contiguous copy."""
    d = t.shape[1]
    if t.shape[0] > 1 and (d == 1 or t.stride(1) == 1) and t.stride(0) >= d:
        return t
    return t.contiguous()


def _check(table: torch.Tensor, idx: torch.Tensor,
           payload: torch.Tensor) -> bool:
    """Validate the arguments; True for CUDA tensors, False for CPU ones."""
    if table.dim() != 2:
        raise ValueError(f"table must be (N, D), got {tuple(table.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"indices must be a 1-D int32 tensor, got "
                        f"{idx.dtype} of shape {tuple(idx.shape)}")
    if payload.shape != (idx.shape[0], table.shape[1]):
        raise ValueError(f"payload must be (M, D) = ({idx.shape[0]}, "
                         f"{table.shape[1]}), got {tuple(payload.shape)}")
    if not idx.device == payload.device == table.device:
        raise ValueError(f"table on {table.device}, indices on {idx.device}, "
                         f"payload on {payload.device}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")
    return table.device.type == "cuda"


def bucket_scatter_add(table: torch.Tensor, idx: torch.Tensor,
                       payload: torch.Tensor) -> torch.Tensor:
    """K5: ``table[idx[i]] += payload[i]`` for every i, out of place, in
    float32; indices in [-N, 0) wrap, the rest outside [0, N) drop.
    Returns the (N, D) result, contiguous."""
    if not _check(table, idx, payload):
        return _ref.bucket_scatter_add_ref(table, idx, payload)
    if table.dtype != torch.float32 or payload.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32 tables and payloads, got "
                        f"{table.dtype} and {payload.dtype}")
    n, d = table.shape
    m = idx.shape[0]
    if m == 0 or n == 0 or d == 0:
        return table.clone(memory_format=torch.contiguous_format)
    if m >= 1 << 31:
        raise ValueError(f"the kernel takes fewer than 2^31 ops, got {m}")
    table, payload, idx = _rows(table), _rows(payload), idx.contiguous()
    geo = geometry(n, d, m, vector_width(table, payload))
    dev = table.device
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    # one allocation: the int workspace, then the floats from a 16-byte
    # boundary
    ints = -(-geo["ws_ints"] // 4) * 4
    ws = torch.empty(ints + geo["scratch_floats"], dtype=torch.int32,
                     device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.roomy_bucket_scatter_add(
            table.data_ptr(), table.stride(0), out.data_ptr(), n, d,
            idx.data_ptr(), m, payload.data_ptr(), payload.stride(0),
            geo["vec"], geo["tile_rows"], geo["warps"], geo["passes"],
            geo["bits"], ws.data_ptr(), geo["ws_ints"],
            ws.data_ptr() + 4 * ints, geo["scratch_floats"], stream)
    if code:
        raise RuntimeError(f"roomy_bucket_scatter_add: CUDA error {code}: "
                           f"{lib.roomy_scatter_error_string(code).decode()}")
    LAUNCHES["bucket_scatter_add"] += 1
    return out

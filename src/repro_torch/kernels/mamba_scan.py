"""Wrappers of the Hopper selective-scan kernels (``csrc/mamba_scan.cu``
and its backward, ``csrc/mamba_scan_bwd.cu``).

Port of ``repro/kernels/mamba_scan.py`` (K9 of the kernel table in
PERF.md): y = the selective scan of x, dt, A, B, C, D, and with
``return_state=True`` also the final (B, Di, N) float32 state, as
``repro/kernels/ref.py:145-164`` (``mamba_scan_seq_stateful``) returns it
for the prefill, or with ``return_chunks=True`` the state after each
chunk of ``CHUNK`` steps, the residual of the backward.  ``mamba_scan``
checks shapes, types and devices, allocates the outputs, launches
``scan_seg_kernel`` (time split across the threads of a block, a carried
prefix; ``geometry`` gives its launch) on the current CUDA stream and
books one launch in ``LAUNCHES["mamba_scan"]``.  ``mamba_scan_bwd`` (K9-bwd,
which the reference lacks: it trains SSMs through its plain scan) takes
the inputs, dy and those chunk states and gives every input's gradient;
it launches ``scan_bwd_kernel`` and ``scan_bwd_reduce_kernel``
(``bwd_geometry``) and books one launch in ``LAUNCHES["mamba_scan_bwd"]``.
The kernels take every case the wrappers accept (float32 and bfloat16,
N <= 64, any L and Di, strided inputs), so there is one route.  For CPU
tensors the wrappers return the plain versions (``ref.mamba_scan_plain``,
``ref.mamba_scan_chunks_plain``, ``ref.mamba_scan_bwd_plain``); for CUDA
tensors they launch the kernels or raise — there is no fallback.  The
autograd Function over the two is ``ops._MambaScan``.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import obs
from . import _build
from . import ref as _ref

MAX_STATE = 64
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: The kernel's block, as ``csrc/mamba_scan.cu``: states a thread, time
#: segments of a chunk, steps a segment, (channel, state group) pairs a
#: block (its threads are LANES x SEGMENTS), and the blocks an SM holds
#: (its launch bounds).
SPT = 4
SEGMENTS = 4
SEG_LEN = 8
CHUNK = SEGMENTS * SEG_LEN
LANES = 64
BLOCKS_PER_SM = 2

#: Kernel launches only, never plain-version calls.
LAUNCHES = obs.counters("ssm", {"mamba_scan": 0, "mamba_scan_bwd": 0})

#: The backward kernel's block, as ``csrc/mamba_scan_bwd.cu``: its threads
#: (one a (channel, state) pair) and the steps between two flushes of its
#: sums.
BWD_THREADS = 256
BWD_SUB = 8


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = None
_BWD_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("mamba_scan")
        # x, dt, a, b, c, d, y, h_last, dtype, B, L, Di, N, strides, tpc,
        # stream
        lib.roomy_mamba_scan.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                         _I, _I, _I, _I, _I, _P, _I, _P]
        lib.roomy_mamba_scan.restype = _I
        lib.roomy_ms_error_string.argtypes = [_I]
        lib.roomy_ms_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _bwd_lib() -> ctypes.CDLL:
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = _build.load("mamba_scan_bwd")
        # x, dt, a, b, c, d, dy, h_chunks, dx, ddt, da, db, dc, dd, work,
        # dtype, B, L, Di, N, strides, np, stream
        lib.roomy_mamba_scan_bwd.argtypes = [_P] * 15 + [_I] * 5 + [_P, _I,
                                                                   _P]
        lib.roomy_mamba_scan_bwd.restype = _I
        lib.roomy_mamba_scan_bwd_work.argtypes = [_I] * 5
        lib.roomy_mamba_scan_bwd_work.restype = ctypes.c_longlong
        lib.roomy_msb_error_string.argtypes = [_I]
        lib.roomy_msb_error_string.restype = ctypes.c_char_p
        _BWD_LIB = lib
    return _BWD_LIB


def check_inputs(x, dt, a, b, c, d) -> None:
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)} and dt {tuple(dt.shape)} must "
                         "share one (B, L, Di) shape")
    bsz, seq, di = x.shape
    if a.dim() != 2 or a.shape[0] != di:
        raise ValueError(f"a {tuple(a.shape)} is not (Di={di}, N)")
    n = a.shape[1]
    if b.shape != (bsz, seq, n) or c.shape != (bsz, seq, n):
        raise ValueError(f"b {tuple(b.shape)} and c {tuple(c.shape)} must "
                         f"be (B, L, N) = {(bsz, seq, n)}")
    if d.shape != (di,):
        raise ValueError(f"d {tuple(d.shape)} is not (Di={di},)")
    if x.dtype not in DTYPES or any(t.dtype != x.dtype for t in (dt, b, c)):
        raise ValueError(f"x, dt, b, c must share one of {list(DTYPES)}, "
                         f"got {x.dtype}, {dt.dtype}, {b.dtype}, {c.dtype}")
    if any(t.device != x.device for t in (dt, a, b, c, d)):
        raise ValueError("x, dt, a, b, c, d must lie on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def geometry(batch: int, seq: int, d_inner: int, n_state: int) -> dict:
    """The launch of ``scan_seg_kernel`` for a call: ``tpc`` threads a
    channel (the next power of two of ceil(N / SPT)), ``channels`` a block,
    ``states`` a channel with the padding, the grid (channel tiles, batch
    rows), ``threads`` a block and the ``chunks`` of CHUNK steps that cover
    L (the last one ragged)."""
    groups = max(1, -(-n_state // SPT))
    tpc = 1 << (groups - 1).bit_length()
    ch = LANES // tpc
    return {"tpc": tpc, "channels": ch, "states": tpc * SPT,
            "grid": (-(-d_inner // ch), batch), "threads": LANES * SEGMENTS,
            "chunks": -(-seq // CHUNK)}


def bwd_geometry(batch: int, seq: int, d_inner: int, n_state: int) -> dict:
    """The launch of ``scan_bwd_kernel``: ``states`` threads a channel (N
    padded to a power of two, one state a thread), ``channels`` a block,
    the grid (channel tiles, batch rows), its dynamic shared memory, and
    the scratch its sums go through: each tile's part of db and dc,
    ``part_bytes`` in all."""
    states = 1 << (max(1, n_state) - 1).bit_length()
    ch = BWD_THREADS // states
    tiles = -(-d_inner // ch)
    warps = max(1, states // 32)
    smem = 4 * ((CHUNK + 2 * BWD_SUB) * BWD_THREADS + 2 * BWD_SUB * ch * warps)
    return {"states": states, "channels": ch, "grid": (tiles, batch),
            "threads": BWD_THREADS, "chunks": -(-seq // CHUNK),
            "smem_bytes": smem,
            "part_bytes": 8 * tiles * batch * seq * n_state}


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` with a contiguous last dim (its batch and time strides kept)."""
    return t if t.stride(-1) == 1 or t.shape[-1] == 1 else t.contiguous()


def _check_launch(x, n) -> None:
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"state size {n} outside 1..{MAX_STATE}")
    if x.shape[0] > 65535:
        raise ValueError(f"batch {x.shape[0]} > 65535")


def _strides(*ts):
    return (ctypes.c_longlong * 8)(*(s for t in ts for s in t.stride()[:2]))


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
               return_state: bool = False, return_chunks: bool = False):
    """K9: x, dt (B, L, Di) and b, c (B, L, N) of one dtype (float32 or
    bfloat16, any batch and time strides), a (Di, N), d (Di,), N <= 64 →
    y (B, L, Di) in x.dtype, and with ``return_state`` also h_last
    (B, Di, N) float32, or with ``return_chunks`` the state after each
    chunk of CHUNK steps, h_chunks (B, ceil(L / CHUNK), Di, N) float32 (the
    last one after step L - 1), as ``mamba_scan_bwd`` reads them.  The
    kernel takes no part in autograd: ``ops.mamba_scan`` runs it through
    ``ops._MambaScan`` when a gradient is wanted."""
    check_inputs(x, dt, a, b, c, d)
    if return_state and return_chunks:
        raise ValueError("return_state and return_chunks exclude each other")
    if x.device.type == "cpu":
        if return_chunks:
            return _ref.mamba_scan_chunks_plain(x, dt, a, b, c, d, CHUNK)
        return _ref.mamba_scan_plain(x, dt, a, b, c, d, return_state)
    bsz, seq, di = x.shape
    n = a.shape[1]
    _check_launch(x, n)
    x, dt, b, c = (_rows(t) for t in (x, dt, b, c))
    a = a.detach().float().contiguous()
    d = d.detach().float().contiguous()
    y = torch.empty((bsz, seq, di), dtype=x.dtype, device=x.device)
    h = (torch.empty((bsz, di, n), dtype=torch.float32, device=x.device)
         if return_state else None)
    hc = (torch.empty((bsz, -(-seq // CHUNK), di, n), dtype=torch.float32,
                      device=x.device) if return_chunks else None)
    strides = _strides(x, dt, b, c)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.roomy_mamba_scan(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), d.data_ptr(), y.data_ptr(),
            None if h is None else h.data_ptr(),
            None if hc is None else hc.data_ptr(), DTYPES[x.dtype], bsz, seq,
            di, n, ctypes.cast(strides, ctypes.c_void_p),
            geometry(bsz, seq, di, n)["tpc"], stream)
    if code:
        raise RuntimeError(f"roomy_mamba_scan: CUDA error {code}: "
                           f"{lib.roomy_ms_error_string(code).decode()}")
    LAUNCHES["mamba_scan"] += 1
    if return_state:
        return y, h
    return (y, hc) if return_chunks else y


def mamba_scan_bwd(x, dt, a, b, c, d, dy, h_chunks):
    """K9-bwd: the inputs of a K9 call, the gradient dy (B, L, Di) of its
    output and its ``h_chunks`` → (dx, ddt (B, L, Di) in x.dtype; da
    (Di, N), db, dc (B, L, N), dd (Di,) float32), the gradient of every
    input, in their order.  dy is read in x.dtype."""
    check_inputs(x, dt, a, b, c, d)
    bsz, seq, di = x.shape
    n = a.shape[1]
    chunks = (bsz, -(-seq // CHUNK), di, n)
    if dy.shape != x.shape or tuple(h_chunks.shape) != chunks:
        raise ValueError(f"dy {tuple(dy.shape)} must be x's {tuple(x.shape)}"
                         f" and h_chunks {tuple(h_chunks.shape)} {chunks}")
    if dy.device != x.device or h_chunks.device != x.device:
        raise ValueError("dy and h_chunks must lie on x's device")
    if x.device.type == "cpu":
        return _ref.mamba_scan_bwd_plain(x, dt, a, b, c, d, dy, h_chunks,
                                         CHUNK)
    _check_launch(x, n)
    f32 = dict(dtype=torch.float32, device=x.device)
    if bsz == 0 or seq == 0 or di == 0:       # nothing to launch
        return (torch.zeros_like(x), torch.zeros_like(dt),
                torch.zeros((di, n), **f32), torch.zeros((bsz, seq, n), **f32),
                torch.zeros((bsz, seq, n), **f32), torch.zeros((di,), **f32))
    x, dt, b, c = (_rows(t) for t in (x, dt, b, c))
    a = a.detach().float().contiguous()
    d = d.detach().float().contiguous()
    dy = dy.to(x.dtype).contiguous()
    h_chunks = h_chunks.float().contiguous()
    dx = torch.empty((bsz, seq, di), dtype=x.dtype, device=x.device)
    ddt = torch.empty_like(dx)
    da = torch.empty((di, n), **f32)
    db = torch.empty((bsz, seq, n), **f32)
    dc = torch.empty_like(db)
    dd = torch.empty((di,), **f32)
    states = bwd_geometry(bsz, seq, di, n)["states"]
    lib = _bwd_lib()
    work = torch.empty((lib.roomy_mamba_scan_bwd_work(bsz, seq, di, n,
                                                      states),), **f32)
    strides = _strides(x, dt, b, c)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.roomy_mamba_scan_bwd(
            *(t.data_ptr() for t in (x, dt, a, b, c, d, dy, h_chunks, dx, ddt,
                                     da, db, dc, dd, work)),
            DTYPES[x.dtype], bsz, seq, di, n,
            ctypes.cast(strides, ctypes.c_void_p), states, stream)
    if code:
        raise RuntimeError(f"roomy_mamba_scan_bwd: CUDA error {code}: "
                           f"{lib.roomy_msb_error_string(code).decode()}")
    LAUNCHES["mamba_scan_bwd"] += 1
    return dx, ddt, da, db, dc, dd

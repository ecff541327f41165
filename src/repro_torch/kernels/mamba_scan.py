"""Wrapper of the Hopper selective-scan kernel (``csrc/mamba_scan.cu``).

Port of ``repro/kernels/mamba_scan.py`` (K9 of the kernel table in
PERF.md): y = the selective scan of x, dt, A, B, C, D, and with
``return_state=True`` also the final (B, Di, N) float32 state, as
``repro/kernels/ref.py:145-164`` (``mamba_scan_seq_stateful``) returns it
for the prefill.  The wrapper checks shapes, types and devices, allocates
the outputs, launches ``scan_seg_kernel`` (time split across the threads
of a block, a carried prefix; ``geometry`` gives its launch) on the
current CUDA stream and books one launch in ``LAUNCHES["mamba_scan"]``.
The kernel takes every case the wrapper accepts (float32 and bfloat16,
N <= 64, any L and Di, strided inputs), so there is one route.  For CPU
tensors it returns the plain version (``ref.mamba_scan_plain``); for CUDA
tensors it launches the kernel or raises — there is no fallback.  The
kernel has no backward (the reference has none either): a CUDA call
whose inputs require a gradient raises.
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
LAUNCHES = obs.counters("ssm", {"mamba_scan": 0})


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("mamba_scan")
        # x, dt, a, b, c, d, y, h_last, dtype, B, L, Di, N, strides, tpc,
        # stream
        lib.roomy_mamba_scan.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                         _I, _I, _I, _I, _P, _I, _P]
        lib.roomy_mamba_scan.restype = _I
        lib.roomy_ms_error_string.argtypes = [_I]
        lib.roomy_ms_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


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


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` with a contiguous last dim (its batch and time strides kept)."""
    return t if t.stride(-1) == 1 or t.shape[-1] == 1 else t.contiguous()


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
               return_state: bool = False):
    """K9: x, dt (B, L, Di) and b, c (B, L, N) of one dtype (float32 or
    bfloat16, any batch and time strides), a (Di, N), d (Di,), N <= 64 →
    y (B, L, Di) in x.dtype, and with ``return_state`` also h_last
    (B, Di, N) float32."""
    check_inputs(x, dt, a, b, c, d)
    if x.device.type == "cpu":
        return _ref.mamba_scan_plain(x, dt, a, b, c, d, return_state)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, a, b, c, d)):
        raise NotImplementedError(
            "K9 (mamba_scan) has no backward: SSM training is ROADMAP "
            "item 9.10")
    bsz, seq, di = x.shape
    n = a.shape[1]
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"state size {n} outside 1..{MAX_STATE}")
    if bsz > 65535:
        raise ValueError(f"batch {bsz} > 65535")
    x, dt, b, c = (_rows(t) for t in (x, dt, b, c))
    a = a.float().contiguous()
    d = d.float().contiguous()
    y = torch.empty((bsz, seq, di), dtype=x.dtype, device=x.device)
    h = (torch.empty((bsz, di, n), dtype=torch.float32, device=x.device)
         if return_state else None)
    strides = (ctypes.c_longlong * 8)(*(s for t in (x, dt, b, c)
                                        for s in t.stride()[:2]))
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.roomy_mamba_scan(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), d.data_ptr(), y.data_ptr(),
            None if h is None else h.data_ptr(), DTYPES[x.dtype], bsz, seq,
            di, n, ctypes.cast(strides, ctypes.c_void_p),
            geometry(bsz, seq, di, n)["tpc"], stream)
    if code:
        raise RuntimeError(f"roomy_mamba_scan: CUDA error {code}: "
                           f"{lib.roomy_ms_error_string(code).decode()}")
    LAUNCHES["mamba_scan"] += 1
    return (y, h) if return_state else y

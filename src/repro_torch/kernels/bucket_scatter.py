"""Wrapper of the Hopper segment scatter-add kernel (``csrc/bucket_scatter.cu``).

Port of ``repro/kernels/bucket_scatter.py`` (K5 of the kernel table in
PERF.md): ``out = table; out[idx[i]] += payload[i]`` in float32, the apply
phase of a Roomy sync.  Indices follow the oracle's contract
(``ref.bucket_scatter_add_ref``): [-N, 0) wraps, below -N and >= N drop.

For a table on the CPU the wrapper returns the plain version; for a CUDA
table it launches the kernel or raises — there is no fallback.  The kernel
takes float32 tables and payloads only (the sync's route sends nothing
else).  It reads a table or a payload whose rows are strided (column
stride 1) in place, and books one launch in ``LAUNCHES`` per launch; an
empty ``idx`` gives a copy of the table and launches nothing.
"""
from __future__ import annotations

import ctypes

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
        # table, table_stride, out, n, d, idx, m, pay, pay_stride, stream
        lib.roomy_bucket_scatter_add.argtypes = [_P, _I64, _P, _I64, _I64,
                                                 _P, _I64, _P, _I64, _P]
        lib.roomy_bucket_scatter_add.restype = ctypes.c_int
        lib.roomy_scatter_error_string.argtypes = [ctypes.c_int]
        lib.roomy_scatter_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


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
    table, payload, idx = _rows(table), _rows(payload), idx.contiguous()
    out = torch.empty((n, d), dtype=torch.float32, device=table.device)
    lib = _lib()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        code = lib.roomy_bucket_scatter_add(
            table.data_ptr(), table.stride(0), out.data_ptr(), n, d,
            idx.data_ptr(), m, payload.data_ptr(), payload.stride(0), stream)
    if code:
        raise RuntimeError(f"roomy_bucket_scatter_add: CUDA error {code}: "
                           f"{lib.roomy_scatter_error_string(code).decode()}")
    LAUNCHES["bucket_scatter_add"] += 1
    return out

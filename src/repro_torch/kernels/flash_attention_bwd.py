"""Wrapper of the Hopper flash-attention backward (``csrc/flash_attention_bwd.cu``).

Port of ``repro/kernels/flash_attention_bwd.py`` (K7 of the kernel table
in PERF.md) together with the GQA group sum of ``repro/kernels/ops.py:63-69``:
from the forward's output and row log-sum-exp (K6 with ``return_lse``) it
returns dq (B, Hq, Sq, D) and dk, dv per kv head (B, Hkv, Skv, D), each in
its input's dtype.  The kernel sums each kv head's group in a fixed order,
so the result is the same in every run.

The wrapper checks shapes, types and devices, allocates dq, dk, dv with
``torch.empty_like`` (so they take q's, k's and v's strides) and the
row-sum scratch with ``torch.empty``, launches on the current CUDA stream
and books one launch under ``flash_attention_bwd`` in K6's ``LAUNCHES``.
For CPU tensors it returns the plain version
(``ref.flash_attention_bwd_ref``); for CUDA tensors it launches the
kernel or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from . import ref as _ref
from .flash_attention import (DTYPES, LAUNCHES, check_inputs,
                              last_dim_contiguous)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention_bwd")
        # q, k, v, o, dO, lse, dvec, dq, dk, dv, dtype, B, Hq, Hkv, Sq, Skv,
        # D, strides, causal, window, softcap, scale, stream
        lib.roomy_flash_attention_bwd.argtypes = (
            [_P] * 10 + [_I] * 7 + [_P, _I, _I, _F, _F, _P])
        lib.roomy_flash_attention_bwd.restype = _I
        lib.roomy_fab_error_string.argtypes = [_I]
        lib.roomy_fab_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(q, k, v, o, lse, do, window, softcap) -> None:
    check_inputs(q, k, v, window, softcap)
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} {tuple(x.shape)} {x.dtype} on "
                             f"{x.device} must match q {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}")
    if (lse.shape != q.shape[:3] or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"lse must be float32 {tuple(q.shape[:3])} on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)} on "
                         f"{lse.device}")


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int | None = None,
                        softcap: float | None = None,
                        scale: float | None = None):
    """K7: the gradients of ``flash_attention(q, k, v, ...)`` with respect to
    q, k and v, given its output ``o``, its row log-sum-exp ``lse`` and the
    output's gradient ``do``.  Returns (dq, dk, dv); dk and dv are per kv
    head, the GQA group summed."""
    _check(q, k, v, o, lse, do, window, softcap)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                            causal=causal, window=window,
                                            softcap=softcap, scale=scale)
    q, k, v, o, do = (last_dim_contiguous(x) for x in (q, k, v, o, do))
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dvec = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(s for x in (q, k, v, o, do, dq, dk,
                                                     dv)
                                         for s in x.stride()[:3]))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.roomy_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), DTYPES[q.dtype], b, hq, hkv, sq,
            skv, d, ctypes.cast(strides, ctypes.c_void_p), int(causal),
            -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap), float(scale), stream)
    if code:
        raise RuntimeError(f"roomy_flash_attention_bwd: CUDA error {code}: "
                           f"{lib.roomy_fab_error_string(code).decode()}")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv

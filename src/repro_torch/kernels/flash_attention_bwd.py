"""Wrapper of the Hopper flash-attention backward (``csrc/flash_attention_bwd.cu``).

Port of ``repro/kernels/flash_attention_bwd.py`` (K7 of the kernel table
in PERF.md) together with the GQA group sum of ``repro/kernels/ops.py:63-69``:
from the forward's output and row log-sum-exp (K6 with ``return_lse``) it
returns dq (B, Hq, Sq, D) and dk, dv per kv head (B, Hkv, Skv, D), each in
its input's dtype.  The kernels sum each kv head's group in a fixed order,
so the result is the same in every run.

The wrapper checks shapes, types and devices, allocates dq, dk, dv with
``torch.empty_like`` (so they take q's, k's and v's strides) and the
row scratch with ``torch.empty``, launches on the current CUDA stream and
books one launch under ``flash_attention_bwd`` in K6's ``LAUNCHES`` and
one under its route in ``BWD_ROUTE_LAUNCHES``.  For CPU tensors it
returns the plain version (``ref.flash_attention_bwd_ref``) and books
nothing; for CUDA tensors it launches its route's kernels or raises —
there is no fallback.

Two routes, chosen by ``route`` before launch from dtype, shape, strides
and alignment alone:

* ``"wgmma"``: the calls K6's ``route`` sends to its wgmma kernel (bf16 at
  head dims 64, 128 and 256, TMA-ready q, k, v, o) whose dO is TMA-ready
  too: a row pass (lse·log2 e and Dv = rowsum(dO ∘ O)), then
  ``dkdv_hopper_kernel`` and ``dq_hopper_kernel``, TMA loads into rings,
  one producer and two consumer warpgroups, wgmma.  The wrapper passes
  q, dO, k and v as 4-D tensor maps (``tma_geometry``), once with each
  kernel's tile rows (``DQ_TILES``, ``DKDV_TILES``).
* ``"classic"``: everything else (float32, the smoke configs' head dims,
  odd strides): the mma.sync and float32 kernels.
"""
from __future__ import annotations

import array
import ctypes
import math

import torch

from . import _build
from . import ref as _ref
from .flash_attention import (BWD_ROUTE_LAUNCHES, DTYPES, LAUNCHES,
                              check_inputs, last_dim_contiguous, tma_geometry,
                              tma_ready)
from .flash_attention import route as _fwd_route

#: The wgmma route's tiles by head dim, as ``DqTile`` and ``KvTile`` in
#: ``csrc/flash_attention_bwd.cu``: the dQ kernel's (q rows, kv rows) a
#: CTA, and the dK/dV kernel's (kv rows a CTA, q rows a tile).
DQ_TILES = {64: (128, 128), 128: (128, 128), 256: (128, 64)}
DKDV_TILES = {64: (64, 128), 128: (64, 128), 256: (64, 64)}
#: The row scratch's Sq is rounded up to this (``kRowPad``): every tile's
#: rows are one aligned bulk copy.
ROW_PAD = 128
#: Keys a dK/dV CTA holds (``kBKV``).
DKDV_KEYS = 64

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
        # q, k, v, o, dO, lse, rows, dq, dk, dv, B, Hq, Hkv, Sq, Skv, D,
        # strides, maps, causal, window, softcap, scale, stream
        lib.roomy_flash_attention_bwd_tma.argtypes = (
            [_P] * 10 + [_I] * 6 + [_P, _P, _I, _I, _F, _F, _P])
        lib.roomy_flash_attention_bwd_tma.restype = _I
        lib.roomy_flash_attention_bwd_tma_smem.argtypes = [_I, _I]
        lib.roomy_flash_attention_bwd_tma_smem.restype = _I
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


def route(q, k, v, o, do) -> str:
    """The kernels that take a call (as the wrapper makes its inputs):
    ``"wgmma"`` when K6's ``route`` sends (q, k, v, o) to its wgmma kernel
    and dO is ``tma_ready`` too; ``"classic"`` otherwise."""
    if _fwd_route(q, k, v, o) == "wgmma" and tma_ready(do):
        return "wgmma"
    return "classic"


def tma_maps(q, k, v, do) -> tuple:
    """The 8 × 11 map geometry the wgmma route's entry point takes: q, dO,
    k, v with the dQ kernel's tile rows, then with the dK/dV kernel's."""
    d = q.shape[-1]
    (bq, bk), (bkv, bq2) = DQ_TILES[d], DKDV_TILES[d]
    return (tma_geometry(q, bq) + tma_geometry(do, bq) + tma_geometry(k, bk)
            + tma_geometry(v, bk) + tma_geometry(q, bq2)
            + tma_geometry(do, bq2) + tma_geometry(k, bkv)
            + tma_geometry(v, bkv))


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
    path = route(q, k, v, o, do)
    mask = (int(causal), -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap), float(scale))
    # the (batch, head, seq) strides the route's entry point takes, in an
    # array.array: cheaper on the host than a ctypes array
    strided = ((o, do, dq, dk, dv) if path == "wgmma"
               else (q, k, v, o, do, dq, dk, dv))
    strides = array.array("q", [s for x in strided for s in x.stride()[:3]])
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if path == "wgmma":
            sqp = -(-sq // ROW_PAD) * ROW_PAD
            rows = torch.empty((2, b, hq, sqp), dtype=torch.float32,
                               device=q.device)
            maps = array.array("q", tma_maps(q, k, v, do))
            name = "roomy_flash_attention_bwd_tma"
            code = lib.roomy_flash_attention_bwd_tma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), rows.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, hq, hkv, sq,
                skv, d, strides.buffer_info()[0], maps.buffer_info()[0],
                *mask, stream)
        else:
            dvec = torch.empty((b, hq, sq), dtype=torch.float32,
                               device=q.device)
            name = "roomy_flash_attention_bwd"
            code = lib.roomy_flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), DTYPES[q.dtype],
                b, hq, hkv, sq, skv, d, strides.buffer_info()[0], *mask,
                stream)
    if code:
        raise RuntimeError(f"{name}: CUDA error {code}: "
                           f"{lib.roomy_fab_error_string(code).decode()}")
    BWD_ROUTE_LAUNCHES[path] += 1
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv

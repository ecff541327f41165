"""Wrapper of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

Port of ``repro/kernels/flash_attention.py`` (K6 of the kernel table in
PERF.md): the forward, and with ``return_lse=True`` the variant that also
returns the (B, Hq, Sq) float32 row log-sum-exp the backward pass (K7,
``flash_attention_bwd.py``) reads.  The wrapper checks shapes, types,
devices and head_dim, allocates the output with ``torch.empty_like(q)``
(so it takes q's strides: a (B, S, H, D) activation viewed as (B, H, S, D)
gives an output whose inverse view is contiguous), launches on the current
CUDA stream and books one launch in ``LAUNCHES``, under
``flash_attention`` or ``flash_attention_lse``.  For CPU tensors it
returns the plain version (``ref.attention_ref`` / ``attention_lse_ref``);
for CUDA tensors it launches the kernel or raises — there is no fallback.

Two routes, chosen by ``route`` before launch from dtype, shape, strides
and alignment alone, and booked in ``ROUTE_LAUNCHES``:

* ``"wgmma"``: bfloat16 at head dims 64, 128 and 256 (minicpm-2b,
  nemotron-4-15b and granite-34b, gemma2-2b) with q, k, v, o 16-byte
  aligned and every stride a multiple of 8 elements (TMA's 16-byte rule):
  ``fa_hopper_kernel``, TMA loads of K/V into a ring, warp-specialised,
  wgmma.  The wrapper passes each of q, k, v as a 4-D tensor map
  (``tma_geometry``).
* ``"classic"``: everything else (float32, the smoke configs' head dims,
  odd strides): ``fa_bf16_kernel`` (mma.sync) and ``fa_f32_kernel``.

A route's kernel that fails to build or launch raises; neither route
stands in for the other.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core import obs
from . import _build
from . import ref as _ref

MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches (launches only, never plain-version calls): K6 without
#: and with the LSE output, and K7 (booked by ``flash_attention_bwd.py``).
LAUNCHES = obs.counters("attention", {"flash_attention": 0,
                                      "flash_attention_lse": 0,
                                      "flash_attention_bwd": 0})


#: K6 launches (with and without the LSE) by route; K7 books none here.
ROUTE_LAUNCHES = obs.counters("attention_route", {"wgmma": 0, "classic": 0})

#: K7 launches by route (booked by ``flash_attention_bwd.py``).
BWD_ROUTE_LAUNCHES = obs.counters("attention_bwd_route",
                                  {"wgmma": 0, "classic": 0})

#: The Hopper route's tiles by head dim: (q rows, kv rows) a CTA, as
#: ``Tile`` in ``csrc/flash_attention.cu``.
TMA_TILES = {64: (128, 128), 128: (128, 128), 256: (128, 64)}
#: Columns of a TMA box: one 128-byte row of the 128-byte swizzle.
TMA_BOX_COLS = 64


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTE_LAUNCHES, BWD_ROUTE_LAUNCHES):
        for k in counts:
            counts[k] = 0


def tma_ready(x: torch.Tensor) -> bool:
    """TMA can read the (B, H, S, D) view ``x`` as a 4-D map: not empty, the
    last dim contiguous, a 16-byte aligned base, and the stride of every
    dim longer than 1 a positive multiple of 8 elements (16 bytes)."""
    if x.numel() == 0 or x.stride(-1) != 1 or x.data_ptr() % 16:
        return False
    return not any(n > 1 and (st <= 0 or st % 8)
                   for n, st in zip(x.shape[:3], x.stride()[:3]))


def route(q, k, v, o) -> str:
    """The kernel that takes a call (q, k, v, o of one dtype, as
    ``check_inputs`` and the wrapper make them): ``"wgmma"`` when they are
    bfloat16 with a head dim in ``TMA_TILES`` and each is ``tma_ready``;
    ``"classic"`` otherwise."""
    if q.dtype != torch.bfloat16 or q.shape[-1] not in TMA_TILES:
        return "classic"
    return "wgmma" if all(tma_ready(x) for x in (q, k, v, o)) else "classic"


def tma_geometry(x: torch.Tensor, rows: int) -> tuple:
    """The 4-D TMA map of a (B, H, S, D) view, as 11 ints: dims innermost
    first (D, S, H, B), the byte strides of S, H and B, and the box
    (``TMA_BOX_COLS`` columns, ``rows`` rows, 1 head, 1 batch row).  A box
    spans one head and one batch row, so a tile never reads into the next
    head; rows past S come in as zeros.  A dim of extent 1 is never
    stepped over, so its stride is given as D's row (any multiple of 16
    bytes does)."""
    b, h, s, d = x.shape
    es = x.element_size()
    strides = tuple((st if n > 1 else d) * es
                    for n, st in ((s, x.stride(2)), (h, x.stride(1)),
                                  (b, x.stride(0))))
    return (d, s, h, b) + strides + (TMA_BOX_COLS, rows, 1, 1)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention")
        # q, k, v, o, lse, dtype, B, Hq, Hkv, Sq, Skv, D, strides, causal,
        # window, softcap, scale, stream
        lib.roomy_flash_attention.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I,
                                              _I, _I, _I, _I, _P, _I, _I, _F,
                                              _F, _P]
        lib.roomy_flash_attention.restype = _I
        # q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, o_strides, maps, causal,
        # window, softcap, scale, stream
        lib.roomy_flash_attention_tma.argtypes = [_P, _P, _P, _P, _P, _I, _I,
                                                  _I, _I, _I, _I, _P, _P, _I,
                                                  _I, _F, _F, _P]
        lib.roomy_flash_attention_tma.restype = _I
        lib.roomy_flash_attention_tma_smem.argtypes = [_I]
        lib.roomy_flash_attention_tma_smem.restype = _I
        lib.roomy_fa_error_string.argtypes = [_I]
        lib.roomy_fa_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check_inputs(q, k, v, window, softcap) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D: (B, H, S, D)")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit (B, Hq, Sq, D), "
                         "(B, Hkv, Skv, D)")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"{hq} query heads are not a multiple of "
                         f"{k.shape[1]} kv heads")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside 1..{MAX_HEAD_DIM}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one of {list(DTYPES)}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if window is not None and window < 0:
        raise ValueError(f"window {window} < 0")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap {softcap} must be > 0")


def last_dim_contiguous(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, scale: float | None = None,
                    return_lse: bool = False):
    """K6: q (B, Hq, Sq, D), k, v (B, Hkv, Skv, D), Hq % Hkv == 0, float32
    or bfloat16, 1 <= D <= 256 → (B, Hq, Sq, D) in q.dtype, and with
    ``return_lse`` also the (B, Hq, Sq) float32 row log-sum-exp (-1e30 for
    a row that sees no key).  ``window`` is the number of previous
    positions visible (self excluded); q and k positions both count
    from 0."""
    check_inputs(q, k, v, window, softcap)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        if return_lse:
            return _ref.attention_lse_ref(q, k, v, **kw)
        return _ref.attention_ref(q, k, v, **kw)
    q, k, v = (last_dim_contiguous(x) for x in (q, k, v))
    out = torch.empty_like(q)
    b, hq, sq, d = q.shape
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    hkv, skv = k.shape[1], k.shape[2]
    path = route(q, k, v, out)
    lib = _lib()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr())
    mask = (int(causal), -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap), float(scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if path == "wgmma":
            bq, bk = TMA_TILES[d]
            maps = (ctypes.c_longlong * 33)(*tma_geometry(q, bq),
                                            *tma_geometry(k, bk),
                                            *tma_geometry(v, bk))
            ostr = (ctypes.c_longlong * 3)(*out.stride()[:3])
            name = "roomy_flash_attention_tma"
            code = lib.roomy_flash_attention_tma(
                *ptrs, b, hq, hkv, sq, skv, d,
                ctypes.cast(ostr, ctypes.c_void_p),
                ctypes.cast(maps, ctypes.c_void_p), *mask, stream)
        else:
            strides = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, out)
                                                 for s in x.stride()[:3]))
            name = "roomy_flash_attention"
            code = lib.roomy_flash_attention(
                *ptrs, DTYPES[q.dtype], b, hq, hkv, sq, skv, d,
                ctypes.cast(strides, ctypes.c_void_p), *mask, stream)
    if code:
        raise RuntimeError(f"{name}: CUDA error {code}: "
                           f"{lib.roomy_fa_error_string(code).decode()}")
    ROUTE_LAUNCHES[path] += 1
    if return_lse:
        LAUNCHES["flash_attention_lse"] += 1
        return out, lse
    LAUNCHES["flash_attention"] += 1
    return out

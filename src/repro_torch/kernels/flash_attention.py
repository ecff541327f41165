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


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    strides = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, out)
                                         for s in x.stride()[:3]))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.roomy_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            DTYPES[q.dtype], b, hq, hkv, sq, skv, d,
            ctypes.cast(strides, ctypes.c_void_p), int(causal),
            -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap), float(scale), stream)
    if code:
        raise RuntimeError(f"roomy_flash_attention: CUDA error {code}: "
                           f"{lib.roomy_fa_error_string(code).decode()}")
    if return_lse:
        LAUNCHES["flash_attention_lse"] += 1
        return out, lse
    LAUNCHES["flash_attention"] += 1
    return out

"""Rotary position embeddings — standard RoPE and qwen2-vl's M-RoPE
(``repro/models/rope.py``).

M-RoPE splits the head_dim/2 rotary frequencies into sections, each
driven by its own position stream (temporal, height, width).  The vision
frontend is a stub, so the 3-row positions arrive as inputs; a text token
repeats one position in all three streams, and M-RoPE then equals RoPE.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch


def _freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


@functools.lru_cache(maxsize=None)
def _section_ids(sections: Tuple[int, ...], device) -> torch.Tensor:
    """(sum(sections),) int64: stream j repeated ``sections[j]`` times."""
    return torch.tensor([j for j, n in enumerate(sections) for _ in range(n)],
                        dtype=torch.int64, device=device)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D) rotated by the float32 angles (..., S, D/2), the
    two halves of D in float32, cast back to x's dtype."""
    half = x.shape[-1] // 2
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) integer."""
    freqs = _freqs(x.shape[-1], theta, x.device)              # (half,)
    return _rotate(x, positions[..., None].float() * freqs)


def mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
          sections: Tuple[int, ...]) -> torch.Tensor:
    """x: (..., S, H, D); positions3: (..., S, 3), the (t, h, w) streams.
    Frequency pair i turns with stream ``sec_id[i]``, where ``sec_id``
    repeats 0, 1, 2, … ``sections`` times each; ``sections`` sums to D/2."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = _freqs(x.shape[-1], theta, x.device)              # (half,)
    sec_id = _section_ids(tuple(sections), x.device)          # (half,)
    pos = positions3.float()[..., sec_id]                     # (..., S, half)
    return _rotate(x, pos * freqs)

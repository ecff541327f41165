"""Permutation rank/unrank — the index space of the implicit bit-array BFS.

Port of ``repro/core/ranking.py``.  The same Myrvold–Ruskey bijection
{permutations of n} ↔ [0, n!), bit-identical to ``unrank_np``/``rank_np``
and ``unrank_jnp``/``rank_jnp``:

    unrank(r):  pi = identity; for i = n..1: swap(pi[i-1], pi[r % i]); r //= i
    rank(pi):   for i = n..2: emit s = pi[i-1]; swap pi so value i-1 lands at
                slot i-1 (and fix pi⁻¹); fold r = r·i + s  (i ascending)

Ranks are one int64 (20! < 2⁶³), so the JAX package's base-2¹⁶ two-word
arithmetic is not needed.  The rank-row form (``ranks_to_rows`` /
``rows_to_ranks``: uint32 words, word 0 high, held in int32 tensors with
the same bits) exists for parity with the JAX rows.
"""
from __future__ import annotations

import math

import torch

MAX_N = 20          # 20! < 2^63: one int64 per rank (two uint32 row words)
MAX_N_1WORD = 12    # 12! < 2^32: single-word rank rows


def rank_width(n: int) -> int:
    """Row width (uint32 words) needed to hold ranks in [0, n!)."""
    assert 1 <= n <= MAX_N, f"rank/unrank supports n <= {MAX_N}"
    return 1 if n <= MAX_N_1WORD else 2


def n_states(n: int) -> int:
    return math.factorial(n)


def unrank(n: int, ranks: torch.Tensor) -> torch.Tensor:
    """Batched unrank: (m,) int64 ranks → (m, n) int64 permutations."""
    assert 1 <= n <= MAX_N
    r = ranks.reshape(-1).to(torch.int64)
    m = r.shape[0]
    pi = torch.arange(n, dtype=torch.int64, device=r.device).repeat(m, 1)
    for i in range(n, 1, -1):           # i = 1 swaps pi[0] with itself
        s = (r % i).unsqueeze(1)
        r = r // i
        a = pi[:, i - 1].clone()
        pi[:, i - 1] = pi.gather(1, s).squeeze(1)
        pi.scatter_(1, s, a.unsqueeze(1))
    return pi


def rank(perms: torch.Tensor) -> torch.Tensor:
    """Batched rank: (m, n) permutations → (m,) int64 ranks.

    Only columns below i-1 are read after step i, so each step writes just
    the two entries that move there: pi[j] ← s and pi⁻¹[s] ← j."""
    pi = perms.to(torch.int64).clone()
    m, n = pi.shape
    assert 1 <= n <= MAX_N
    cols = torch.arange(n, dtype=torch.int64, device=pi.device).expand(m, n)
    pinv = torch.empty_like(pi).scatter_(1, pi, cols)
    s_seq = []
    for i in range(n, 1, -1):
        s = pi[:, i - 1:i].clone()
        j = pinv[:, i - 1:i].clone()
        pi.scatter_(1, j, s)
        pinv.scatter_(1, s, j)
        s_seq.append(s.squeeze(1))
    r = torch.zeros(m, dtype=torch.int64, device=pi.device)
    for i, s in zip(range(2, n + 1), reversed(s_seq)):
        r = r * i + s
    return r


def ranks_to_rows(ranks: torch.Tensor, n: int) -> torch.Tensor:
    """int64 ranks → (m, rank_width(n)) rows of uint32 words (as int32 bits),
    word 0 most significant."""
    r = ranks.reshape(-1).to(torch.int64)
    lo = (r & 0xFFFFFFFF).to(torch.int32)          # wraps: same 32 bits
    if rank_width(n) == 1:
        return lo.unsqueeze(1)
    return torch.stack([(r >> 32).to(torch.int32), lo], dim=1)


def rows_to_ranks(rows: torch.Tensor) -> torch.Tensor:
    """(m, 1|2) rows of uint32 words (as int32 bits) → (m,) int64 ranks."""
    words = rows.to(torch.int64) & 0xFFFFFFFF
    if words.shape[1] == 1:
        return words[:, 0]
    return (words[:, 0] << 32) | words[:, 1]

"""Plain PyTorch versions of the port's kernels (``kernels/csrc/*.cu``).

Twins of ``repro/kernels/ref.py``: the bit-pack functions of ``:251-294``,
the segment scatter-add of ``:240-246`` (K5, and the mirror of K5's own
order of sums, ``bucket_scatter_add_ordered``), the attention functions of
``:23-123`` and the selective scans of ``:126-169`` (K9), plus the
forward with its log-sum-exp and the backward of
``repro/kernels/flash_attention.py:100-111`` and
``flash_attention_bwd.py`` (K6's LSE output and K7), the paged decode
attention of ``repro/kernels/paged_decode.py`` (K8), and the selective
scan's forward with its chunk states and its backward (K9-bwd), which the
reference lacks (it takes ``jax.grad`` through its plain scans).  Beside
them sit two
pieces of model math that no kernel replaces: mamba2's chunked SSD form
(``mamba2_ssd``, ``ref.py:174-236``), which the zamba2 path runs as torch
matmuls, as mamba1's prefill runs ``mamba_scan_seq_stateful`` in the
reference, and the MoE one-hot dispatch (``moe_einsum_onehot``,
``repro/models/moe.py:64-92``), the plain form ``models/moe.py``'s index
dispatch is held to.  They are
device-agnostic: the CPU tests run them as the port's only path there,
and ``chip_smoke.py`` runs them on CUDA tensors to hold each kernel
against them (bit for bit for the bit-pack kernels, within the float
tolerances for attention).

Packed words are int32 tensors holding the uint32 bits.  Unpacking shifts
arithmetically, which is harmless because every field is masked with 3;
repacking ORs ``field << 2j``, and ``3 << 30`` wraps to the sign bit.

Attention and the scans compute in float32 whatever the input type and
cast the result to the input's dtype, as the reference does.
"""
from __future__ import annotations

import math

import torch

FIELDS_PER_WORD = 16
NEG_INF = -1e30


def _shifts(device) -> torch.Tensor:
    return torch.arange(FIELDS_PER_WORD, dtype=torch.int32, device=device) * 2


def unpack_fields(packed: torch.Tensor) -> torch.Tensor:
    """(W,) int32 words → (W, 16) int32 fields 0..3 (field j at bits 2j)."""
    return (packed.unsqueeze(1) >> _shifts(packed.device)) & 3


def pack_fields(fields: torch.Tensor) -> torch.Tensor:
    """(W, 16) fields 0..3 → (W,) int32 words (inverse of unpack_fields)."""
    fields = fields.to(torch.int32)
    out = torch.zeros(fields.shape[0], dtype=torch.int32, device=fields.device)
    for j in range(FIELDS_PER_WORD):
        out |= (fields[:, j] & 3) << (2 * j)
    return out


def bitpack_lut_count_ref(packed: torch.Tensor, lut: int, count_val: int):
    """Map every field through the 4-entry ``lut`` (entry v at bits 2v) and
    count fields that map to ``count_val`` — over ALL W·16 fields.
    Returns (new (W,) int32, count () int32)."""
    f = unpack_fields(packed)
    lut_t = torch.tensor(lut, dtype=torch.int32, device=packed.device)
    nf = (lut_t >> (2 * f)) & 3
    cnt = (nf == count_val).sum().to(torch.int32)
    return pack_fields(nf), cnt


def bitpack_scatter_mark_ref(packed: torch.Tensor, idx: torch.Tensor,
                             mark: int, only_if: int) -> torch.Tensor:
    """``packed[idx] ← mark`` where the field *initially* holds ``only_if``;
    negative and out-of-range indices drop.  Order-independent, so
    duplicates are safe."""
    w = packed.shape[0]
    fields = unpack_fields(packed).reshape(-1)
    idx = idx.to(torch.int64)
    idx = idx[(idx >= 0) & (idx < w * FIELDS_PER_WORD)]
    hit = idx[fields[idx] == only_if]          # gathered before any write
    fields[hit] = mark
    return pack_fields(fields.view(w, FIELDS_PER_WORD))


def bitpack_mark_rotate_count_ref(packed: torch.Tensor, idx: torch.Tensor,
                                  lut: int, count_val: int, mark: int,
                                  only_if: int):
    """The scatter-mark version followed by the lut+count version — the two
    passes the fused kernel does in one launch."""
    marked = bitpack_scatter_mark_ref(packed, idx, mark, only_if)
    return bitpack_lut_count_ref(marked, lut, count_val)


#: Words a tile of K1's and K2's binned route holds: 65,536 fields, so a
#: target's offset in its tile fits a uint16 (``csrc/bitpack.cu``).
BIN_TILE_WORDS = 4096


def bitpack_mark_binned(packed: torch.Tensor, idx: torch.Tensor, mark: int,
                        only_if: int, *, tile_words: int = BIN_TILE_WORDS,
                        blocks: int = 1, per_block: int | None = None):
    """The scatter-mark in the binned route's order (``csrc/bitpack.cu``):
    block b's slice of targets is [b·per_block, (b+1)·per_block); each
    block counts its targets per tile of ``tile_words`` words, an exclusive
    scan of the (tile, block) counts in tile-major order gives each run its
    cursor, each target's offset in its tile goes to its run's next slot,
    and each tile sets a hit bit a field from its bin and marks where hit
    and the field held ``only_if``.  The words equal
    ``bitpack_scatter_mark_ref``'s, since a mark does not depend on order.
    Returns (words, tile_start (n_tiles + 1,), bins) as int64/int32."""
    w, m = packed.shape[0], idx.shape[0]
    dev = packed.device
    tile_fields = tile_words * FIELDS_PER_WORD
    n_tiles = -(-w // tile_words)
    per_block = max(1, m if per_block is None else per_block)
    e = idx.to(torch.int64)
    blk = torch.arange(m, device=dev) // per_block
    keep = (e >= 0) & (e < w * FIELDS_PER_WORD)   # the rest never bin
    e, blk = e[keep], blk[keep]
    tile = e // tile_fields
    key = tile * blocks + blk
    # 1. counts[t, b]: block b's targets in tile t
    counts = torch.zeros(n_tiles * blocks, dtype=torch.int64, device=dev)
    counts.index_add_(0, key, torch.ones_like(key))
    # 2. exclusive scan in tile-major order: each (tile, block) run's cursor
    cursor = torch.cumsum(counts, 0) - counts
    tile_start = torch.cat([cursor.view(n_tiles, blocks)[:, 0],
                            counts.sum().view(1)])
    # 3. each target at its run's cursor plus its rank in the run
    order = torch.argsort(key, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=dev) - cursor[key[order]]
    bins = torch.full((e.numel(),), -1, dtype=torch.int32, device=dev)
    bins[cursor[key] + rank] = (e - tile * tile_fields).to(torch.int32)
    # 4. per tile: hit bits from its bin, marks where the field held only_if
    tile_of = torch.repeat_interleave(torch.arange(n_tiles, device=dev),
                                      tile_start.diff())
    hit = torch.zeros(n_tiles * tile_fields, dtype=torch.bool, device=dev)
    hit[tile_of * tile_fields + bins.to(torch.int64)] = True
    fields = unpack_fields(packed).reshape(-1)
    fields = torch.where(hit[:fields.numel()] & (fields == only_if),
                         torch.tensor(mark, dtype=fields.dtype, device=dev),
                         fields)
    return pack_fields(fields.view(w, FIELDS_PER_WORD)), tile_start, bins


def bitpack_gather2_ref(packed: torch.Tensor, idx: torch.Tensor):
    """Plain version of the 2-bit gather (K4): unpack every field, gather
    the one at each index; negative and out-of-range indices give 0.
    Returns (M,) int32."""
    fields = unpack_fields(packed).reshape(-1)
    idx = idx.to(torch.int64).reshape(-1)
    if fields.numel() == 0:
        return torch.zeros(idx.shape, dtype=torch.int32, device=idx.device)
    ok = (idx >= 0) & (idx < fields.shape[0])
    safe = idx.clamp(0, fields.shape[0] - 1)
    return torch.where(ok, fields[safe], 0).to(torch.int32)


def bitpack_gather2_chunked_ref(table, chunk_elems: int, ranks: torch.Tensor,
                                out: torch.Tensor) -> torch.Tensor:
    """Plain version of K4 over a chunk table: for each non-None entry c,
    the plain gather over its words at ``rank − c·chunk_elems`` for the
    ranks of chunk c.  Ranks in a None chunk keep their ``out`` values;
    ranks below 0 or past the last chunk give 0.  In place; returns
    ``out``."""
    ranks = ranks.to(torch.int64)
    chunk = torch.div(ranks, chunk_elems, rounding_mode="floor")
    outside = (ranks < 0) | (chunk >= len(table))
    res = torch.where(outside, torch.zeros_like(out), out)
    for c, words in enumerate(table):
        if words is not None:
            got = bitpack_gather2_ref(words, ranks - c * chunk_elems)
            res = torch.where(chunk == c, got.to(out.dtype), res)
    return out.copy_(res)

# ------------------------------------------------------- bucket scatter

def bucket_scatter_add_ref(table: torch.Tensor, idx: torch.Tensor,
                           payload: torch.Tensor) -> torch.Tensor:
    """Plain version of the segment scatter-add (K5): ``table[idx[i]] +=
    payload[i]`` accumulated in float32 and cast back to ``table.dtype``,
    out of place.  Indices follow the oracle's ``.at[idx].add(mode="drop")``:
    one in [-N, 0) wraps to idx + N, one below -N or at or above N drops."""
    n = table.shape[0]
    idx = idx.to(torch.int64).reshape(-1)
    idx = torch.where(idx < 0, idx + n, idx)
    keep = (idx >= 0) & (idx < n)
    # a dropped op lands on a spare row past the end, which the result
    # leaves out: no boolean mask, so no shape depends on the data
    acc = torch.cat([table.to(torch.float32), table.new_zeros(
        (1,) + tuple(table.shape[1:]), dtype=torch.float32)])
    acc.index_add_(0, torch.where(keep, idx, n), payload.to(torch.float32))
    return acc[:n].to(table.dtype)


#: K5's chunk: a row's ops, in op order, are summed in chunks of this many.
K5_CHUNK = 256


def bucket_scatter_add_ordered(table: torch.Tensor, idx: torch.Tensor,
                               payload: torch.Tensor) -> torch.Tensor:
    """The plain mirror of K5's order of sums: a row's kept ops, in op
    order, fall into chunks of ``K5_CHUNK`` consecutive ops; each chunk's sum
    ``s_k = ((p_kG + p_kG+1) + …)`` is taken left to right from its first
    payload, and ``out[r] = table[r] + (((s_0 + s_1) + s_2) + …)``; a row
    with no op is the table's.  Indices as ``bucket_scatter_add_ref``.  It
    loops over the position within a chunk and over a row's chunk rank,
    with elementwise float32 adds only, so its bits do not depend on the
    device or the run.  Returns ``table.dtype``."""
    n = table.shape[0]
    dev = table.device
    rows = idx.to(torch.int64).reshape(-1)
    rows = torch.where(rows < 0, rows + n, rows)
    ops = torch.nonzero((rows >= 0) & (rows < n)).reshape(-1)
    out = table.to(torch.float32, copy=True)
    if ops.numel() == 0:
        return out.to(table.dtype)
    rows = rows[ops]
    order = torch.sort(rows, stable=True).indices   # by row, op order within
    ops, rows = ops[order], rows[order]
    pay = payload[ops].to(torch.float32)
    pos = torch.arange(ops.numel(), device=dev)
    first = torch.ones_like(rows, dtype=torch.bool)
    first[1:] = rows[1:] != rows[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    k, j = rank // K5_CHUNK, rank % K5_CHUNK
    cid = torch.cumsum(j == 0, 0) - 1                 # the op's chunk
    sums = pay[j == 0].clone()                        # s_k from its first
    for jj in range(1, int(j.max()) + 1):
        at = j == jj
        sums[cid[at]] = sums[cid[at]] + pay[at]
    head = j == 0
    ck = k[head]                                      # each chunk's rank
    rid = torch.cumsum(ck == 0, 0) - 1                # its row's number
    total = sums[ck == 0].clone()
    for kk in range(1, int(ck.max()) + 1):
        at = ck == kk
        total[rid[at]] = total[rid[at]] + sums[at]
    touched = rows[head][ck == 0]
    out[touched] = out[touched] + total
    return out.to(table.dtype)


# ------------------------------------------------------------- attention

def _mask(q_pos, k_pos, seq_kv, causal, window):
    """Visible (q, k) pairs; ``window`` counts previous positions, self
    excluded."""
    m = k_pos < seq_kv
    if causal:
        m = m & (k_pos <= q_pos)
    if window is not None:
        m = m & (k_pos >= q_pos - window)
    return m


def attention_naive(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=None):
    """(B, Hq, Sq, D) x (B, Hkv, Skv, D) with the full (Sq, Skv) logits."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    s = torch.where(_mask(q_pos, k_pos, skv, causal, window), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _attention_blocked(q, k, v, causal, window, softcap, scale, block_k):
    """The flash kernel's arithmetic over kv chunks of ``block_k``, carrying
    (acc, m, l) in float32; returns (acc / l, m, l) with l == 0 read as 1.
    Every chunk is visited: the plain version skips nothing."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    qf = q.float()
    q_pos = torch.arange(sq, device=dev)[:, None]
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=dev)
    for k0 in range(0, skv, block_k):
        kc = k[:, :, k0:k0 + block_k].float().repeat_interleave(g, dim=1)
        vc = v[:, :, k0:k0 + block_k].float().repeat_interleave(g, dim=1)
        s = torch.matmul(qf, kc.transpose(-1, -2)) * scale
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        k_pos = k0 + torch.arange(kc.shape[2], device=dev)[None, :]
        msk = _mask(q_pos, k_pos, skv, causal, window)
        s = torch.where(msk, s, NEG_INF)
        m_cur = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_cur)
        p = torch.where(msk, torch.exp(s - m_cur[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, vc)
        m = m_cur
    l = torch.where(l == 0.0, 1.0, l)
    return acc / l[..., None], m, l


def attention_ref(q, k, v, *, causal=True, window=None, softcap=None,
                  scale=None, block_k: int = 512):
    """Blocked online-softmax attention (the flash kernel's arithmetic)."""
    out, _, _ = _attention_blocked(q, k, v, causal, window, softcap, scale,
                                   block_k)
    return out.to(q.dtype)


def attention_lse_ref(q, k, v, *, causal=True, window=None, softcap=None,
                      scale=None, block_k: int = 512):
    """``attention_ref`` that also returns the (B, Hq, Sq) float32 row
    log-sum-exp ``m + log(l)`` (l == 0 read as 1, so a row that sees no
    key has lse = -1e30), as ``repro/kernels/flash_attention.py:109-111``
    emits it: the residual the backward pass reads."""
    out, m, l = _attention_blocked(q, k, v, causal, window, softcap, scale,
                                   block_k)
    return out.to(q.dtype), m + torch.log(l)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=True,
                            window=None, softcap=None, scale=None,
                            block_k: int = 512):
    """K7's arithmetic (``repro/kernels/flash_attention_bwd.py``) over kv
    chunks of ``block_k``, in float32: D = rowsum(dO∘O), p = exp(s - lse)
    masked to 0 *after* the exp (a row that sees no key gets no gradient),
    dS = p (dP - D), times the softcap derivative 1 - (s/c)², times scale.
    Returns dq (B, Hq, Sq, D) and dk, dv per kv head (B, Hkv, Skv, D), the
    GQA group already summed, each in its input's dtype."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    qf, dof = q.float(), do.float()
    lse = lse.float()[..., None]
    dvec = (dof * o.float()).sum(dim=-1)[..., None]
    q_pos = torch.arange(sq, device=dev)[:, None]
    dq = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, hkv, skv, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, hkv, skv, d), dtype=torch.float32, device=dev)
    for k0 in range(0, skv, block_k):
        kc = k[:, :, k0:k0 + block_k].float().repeat_interleave(g, dim=1)
        vc = v[:, :, k0:k0 + block_k].float().repeat_interleave(g, dim=1)
        n = kc.shape[2]
        s = torch.matmul(qf, kc.transpose(-1, -2)) * scale
        dcap = None
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
            dcap = 1.0 - torch.square(s / softcap)
        k_pos = k0 + torch.arange(n, device=dev)[None, :]
        msk = _mask(q_pos, k_pos, skv, causal, window)
        p = torch.where(msk, torch.exp(torch.where(msk, s, NEG_INF) - lse),
                        0.0)
        dp = torch.matmul(dof, vc.transpose(-1, -2))
        ds = p * (dp - dvec)
        if dcap is not None:
            ds = ds * dcap
        ds = ds * scale
        dq += torch.matmul(ds, kc)
        grouped = (b, hkv, g, n, d)
        dk[:, :, k0:k0 + n] = torch.matmul(ds.transpose(-1, -2), qf
                                           ).reshape(grouped).sum(2)
        dv[:, :, k0:k0 + n] = torch.matmul(p.transpose(-1, -2), dof
                                           ).reshape(grouped).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_ref(q, k, v, mask, *, softcap=None, scale=None):
    """One query position over a (gathered) cache, grouped over GQA.

    q: (B, Hq, D); k, v: (B, S, Hkv, D); mask: (B, S) validity.  Products
    of the input type accumulate in float32 (the reference's
    ``preferred_element_type``), and p is cast to ``v.dtype`` before P·V."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, g, d)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, hq, d).to(q.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, lengths, *,
                               softcap=None, scale=None):
    """Plain version of K8 (``repro/kernels/paged_decode.py:33-76``): one
    query position over a paged cache, read through the page table.

    q: (B, Hq, D); k_pages, v_pages: (P, ps, Hkv, D); page_table: (B, pps)
    integer page ids; lengths: (B,).  Positions past min(length, pps·ps)
    are masked, and their table entries are replaced by page 0 before the
    gather, so they may hold anything.  Scores, probabilities and P·V are
    float32 (where ``decode_attention_ref`` casts p to ``v.dtype``); a row
    of length 0 gives 0, as the TPU kernel's ``safe_l``."""
    b, hq, d = q.shape
    _, ps, hkv, _ = k_pages.shape
    pps = page_table.shape[1]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    n = lengths.long().clamp(0, pps * ps)
    live = (torch.arange(pps, device=q.device)[None, :] * ps) < n[:, None]
    table = torch.where(live, page_table.long(), 0)
    k = k_pages[table].reshape(b, pps * ps, hkv, d).float()
    v = v_pages[table].reshape(b, pps * ps, hkv, d).float()
    mask = (torch.arange(pps * ps, device=q.device)[None, :]
            < n[:, None])[:, None, None, :]
    qg = q.reshape(b, hkv, g, d).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p, v) / torch.where(l == 0, 1.0, l)
    return out.reshape(b, hq, d).to(q.dtype)


# ------------------------------------------------------------ mamba scan

# Above this length the dispatchers run the sequential form: the
# associative one materialises (B, L, Di, N) several times over
# (``repro/kernels/ops.py:107-113``).
ASSOC_MAX_LEN = 512


def mamba_scan_ref(x, dt, a, b, c, d):
    """The associative form of the selective scan (``ref.py:126-142``):
    each step is the affine map h -> exp(dt·A)·h + (dt·x)·B, composed over
    time by a doubling (Hillis-Steele) scan, in float32.  x, dt (B, L, Di),
    a (Di, N), b, c (B, L, N), d (Di,) → y (B, L, Di) in x.dtype."""
    xf, dtf = x.float(), dt.float()
    bf, cf = b.float(), c.float()
    da = torch.exp(dtf[..., None] * a.float())                # (B, L, Di, N)
    h = (dtf * xf)[..., None] * bf[:, :, None, :]             # (B, L, Di, N)
    k = 1
    while k < x.shape[1]:
        # (a1, b1) then (a2, b2) compose to (a1·a2, b1·a2 + b2)
        h = torch.cat([h[:, :k], h[:, :-k] * da[:, k:] + h[:, k:]], dim=1)
        da = torch.cat([da[:, :k], da[:, :-k] * da[:, k:]], dim=1)
        k *= 2
    y = torch.einsum("blin,bln->bli", h, cf) + xf * d.float()
    return y.to(x.dtype)


def _seq_scan(x, dt, a, b, c, d, h0=None, every=None):
    """The sequential loop over time, vectorised over batch, channel and
    state, in float32: (y (B, L, Di) float32, h_last, and with ``every``
    the list of the states after each ``every`` steps and after the
    last)."""
    bsz, seq, di = x.shape
    xf, dtf = x.float(), dt.float()
    bf, cf = b.float(), c.float()
    af, df = a.float(), d.float()
    h = (torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    y = torch.empty((bsz, seq, di), dtype=torch.float32, device=x.device)
    kept = []
    for t in range(seq):
        dtt, xt = dtf[:, t], xf[:, t]
        h = h * torch.exp(dtt[..., None] * af) \
            + (dtt * xt)[..., None] * bf[:, t, None, :]
        y[:, t] = (h * cf[:, t, None, :]).sum(-1) + xt * df
        if every and ((t + 1) % every == 0 or t == seq - 1):
            kept.append(h)
    return y, h, kept


def mamba_scan_seq_stateful(x, dt, a, b, c, d, h0=None):
    """The sequential form with its final state, the prefill's
    (``ref.py:145-164``): a loop over time, vectorised over batch, channel
    and state, in float32.  Returns (y (B, L, Di) in x.dtype, h_last
    (B, Di, N) float32); ``h0`` (B, Di, N) is the state before step 0
    (zeros when None)."""
    y, h, _ = _seq_scan(x, dt, a, b, c, d, h0)
    return y.to(x.dtype), h


def mamba_scan_seq_ref(x, dt, a, b, c, d):
    """The sequential form's y alone (``ref.py:167-169``)."""
    return mamba_scan_seq_stateful(x, dt, a, b, c, d)[0]


def mamba_scan_segmented(x, dt, a, b, c, d, seg_len=8):
    """K9's order of sums (``csrc/mamba_scan.cu``), in plain PyTorch: time
    cut into segments of ``seg_len`` steps (the tail padded with dt = 0,
    x = 0, which leaves h as it was).  Each segment is walked from h = 0:
    with e = exp(dt·a) and u = dt·x·b, P <- P·e (the product of its
    decays) and B <- B·e + u (its state), its part of y_t = d·x_t +
    sum_j c_t[j]·B_t[j], and the weights c_t[j]·P_t[j].  The segments'
    maps (P, B) fold in time order from h = 0, h <- P·h + B, the fold before
    each segment being its prefix h_in; then y_t += sum_j c_t[j]·P_t[j]·
    h_in[j].  The kernel's chunks of segments fold in the same order, so
    their boundaries do not show.  Float32 throughout; returns (y (B, L,
    Di) in x.dtype, h_last (B, Di, N) float32).  Used by the tests and
    ``chip_smoke.py`` only: the plain version the port runs is
    ``mamba_scan_plain``."""
    bsz, seq, di = x.shape
    n = a.shape[1]
    pad = (-seq) % seg_len
    segs = (seq + pad) // seg_len

    def cut(t):
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
        return t.reshape(bsz, segs, seg_len, t.shape[-1])
    xs, dts, bs, cs = cut(x), cut(dt), cut(b), cut(c)
    af, df = a.float(), d.float()
    big_p = torch.ones((bsz, segs, di, n), dtype=torch.float32,
                       device=x.device)
    big_b = torch.zeros_like(big_p)
    y = torch.empty((bsz, segs, seg_len, di), dtype=torch.float32,
                    device=x.device)
    c_p = torch.empty((bsz, segs, seg_len, di, n), dtype=torch.float32,
                      device=x.device)
    for k in range(seg_len):
        e = torch.exp(dts[:, :, k, :, None] * af)
        u = (dts[:, :, k] * xs[:, :, k])[..., None] * bs[:, :, k, None, :]
        big_p = big_p * e
        big_b = big_b * e + u
        ck = cs[:, :, k, None, :]
        y[:, :, k] = (ck * big_b).sum(-1) + xs[:, :, k] * df
        c_p[:, :, k] = ck * big_p
    h = torch.zeros((bsz, di, n), dtype=torch.float32, device=x.device)
    prefix = torch.empty_like(big_p)
    for s in range(segs):
        prefix[:, s] = h
        h = big_p[:, s] * h + big_b[:, s]
    y = y + (c_p * prefix[:, :, None]).sum(-1)
    y = y.reshape(bsz, segs * seg_len, di)[:, :seq]
    return y.to(x.dtype), h


#: Steps between the states K9 saves for its backward (``csrc/mamba_scan.cu``
#: writes the state after each of its chunks).
SCAN_CHUNK = 32


def mamba_scan_chunks_plain(x, dt, a, b, c, d, chunk: int = SCAN_CHUNK):
    """The sequential form with the residual of the backward: (y (B, L, Di)
    in x.dtype, h_chunks (B, ceil(L / chunk), Di, N) float32, the state
    after each ``chunk`` steps, the last one after step L - 1)."""
    y, _, kept = _seq_scan(x, dt, a, b, c, d, every=chunk)
    return y.to(x.dtype), torch.stack(kept, 1)


def mamba_scan_bwd_plain(x, dt, a, b, c, d, dy, h_chunks,
                         chunk: int = SCAN_CHUNK):
    """The backward of the selective scan from the forward's chunk states:
    K9-bwd's arithmetic (``csrc/mamba_scan_bwd.cu``) in plain PyTorch, in
    float32.  With e_t = exp(dt_t·a), the chunks are walked in reverse;
    each chunk's states are recomputed from the state before it
    (``h_chunks[:, k - 1]``, zeros for the first), h_t = e_t·h_{t-1} +
    dt_t·x_t·b_t, and the adjoint g_t = dL/dh_t runs backwards,
    g_t = dy_t·c_t + e_{t+1}·g_{t+1}, carried across chunk boundaries:
      dx_t = sum_j g_t·dt_t·b_t + dy_t·d,
      ddt_t = sum_j g_t·(a·e_t·h_{t-1} + x_t·b_t),
      da = sum_{b,t} g_t·dt_t·e_t·h_{t-1},   db_t = sum_i g_t·dt_t·x_t,
      dc_t = sum_i dy_t·h_t,                 dd = sum_{b,t} dy_t·x_t.
    Returns (dx, ddt in x.dtype; da (Di, N), db, dc (B, L, N), dd (Di,)
    float32), in the order of the inputs."""
    bsz, seq, di = x.shape
    n = a.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    xf, dtf, bf, cf, dyf = (t.float() for t in (x, dt, b, c, dy))
    af, df = a.float(), d.float()
    dx = torch.empty((bsz, seq, di), **f32)
    ddt = torch.empty_like(dx)
    db = torch.empty((bsz, seq, n), **f32)
    dc = torch.empty_like(db)
    da = torch.zeros((di, n), **f32)
    gn = torch.zeros((bsz, di, n), **f32)         # g_{t+1}
    e_next = torch.ones_like(gn)                  # e_{t+1}
    for k in reversed(range(h_chunks.shape[1])):
        t0, t1 = k * chunk, min(seq, (k + 1) * chunk)
        hs = [torch.zeros_like(gn) if k == 0 else h_chunks[:, k - 1].float()]
        es = []
        for t in range(t0, t1):
            es.append(torch.exp(dtf[:, t, :, None] * af))
            hs.append(hs[-1] * es[-1]
                      + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :])
        for t in reversed(range(t0, t1)):
            e, h_prev, h = es[t - t0], hs[t - t0], hs[t - t0 + 1]
            dtt, xt = dtf[:, t, :, None], xf[:, t, :, None]
            g = dyf[:, t, :, None] * cf[:, t, None, :] + e_next * gn
            dx[:, t] = (g * dtt * bf[:, t, None, :]).sum(-1) + dyf[:, t] * df
            ddt[:, t] = (g * (af * e * h_prev + xt * bf[:, t, None, :])
                         ).sum(-1)
            da += (g * dtt * e * h_prev).sum(0)
            db[:, t] = (g * dtt * xt).sum(1)
            dc[:, t] = (dyf[:, t, :, None] * h).sum(1)
            gn, e_next = g, e
    dd = (dyf * xf).sum((0, 1))
    return dx.to(x.dtype), ddt.to(dt.dtype), da, db, dc, dd


def mamba_scan_bwd_segmented(x, dt, a, b, c, d, dy, h_chunks,
                             chunk: int = SCAN_CHUNK, seg_len: int = 8):
    """K9-bwd's order of sums (``csrc/mamba_scan_bwd.cu``), in plain
    PyTorch: the function of ``mamba_scan_bwd_plain``, with each chunk of
    ``chunk`` steps cut into segments of ``seg_len`` (steps past L padded
    with zeros: e = 1, no input, no adjoint).  Each segment is walked from
    h = 0 with e_t = exp(dt_t·a): P <- P·e_t (the product of its decays),
    B <- B·e_t + dt_t·x_t·b_t (its state's map, h_out = P·h_in + B) and
    G <- G + P·dy_t·c_t (its adjoint's map, w_out = P·w_in + G, where w is
    e_{t+1}·g_{t+1}, what flows in from the step after the segment).  The
    state's maps fold in time order from each chunk's start state
    (``h_chunks[:, k - 1]``, zeros for the first), the fold before a
    segment being its h_in; the adjoint's fold in reverse over all of time,
    the chunks in reverse, from 0, the fold after a segment being its w_in.
    Then each segment walks forward from h_in (the states before each step,
    and dc_t = sum_i dy_t·h_t) and back from w_in: g_t = dy_t·c_t + w_in at
    its last step and dy_t·c_t + e_{t+1}·g_{t+1} before, with the terms of
    ``mamba_scan_bwd_plain``.  Float32 throughout; returns (dx, ddt in
    x.dtype; da (Di, N), db, dc (B, L, N), dd (Di,) float32).  Used by the
    tests and ``chip_smoke.py`` only: the plain version the port runs is
    ``mamba_scan_bwd_plain``."""
    bsz, seq, di = x.shape
    n = a.shape[1]
    nch = h_chunks.shape[1]
    segs = chunk // seg_len
    pad = nch * chunk - seq

    def cut(t):       # (B, L, C) -> (B, chunks, segments, seg_len, C)
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
        return t.reshape(bsz, nch, segs, seg_len, t.shape[-1])
    xs, dts, bs, cs, dys = cut(x), cut(dt), cut(b), cut(c), cut(dy)
    af, df = a.float(), d.float()
    f32 = dict(dtype=torch.float32, device=x.device)
    e = [torch.exp(dts[:, :, :, r, :, None] * af) for r in range(seg_len)]
    u = [(dts[:, :, :, r] * xs[:, :, :, r])[..., None]
         * bs[:, :, :, r, None, :] for r in range(seg_len)]
    dyc = [dys[:, :, :, r, :, None] * cs[:, :, :, r, None, :]
           for r in range(seg_len)]
    big_p = torch.ones((bsz, nch, segs, di, n), **f32)
    big_b = torch.zeros_like(big_p)
    big_g = torch.zeros_like(big_p)
    for r in range(seg_len):
        big_p = big_p * e[r]
        big_b = big_b * e[r] + u[r]
        big_g = big_g + big_p * dyc[r]
    # the state's fold within each chunk, from its start state
    h = torch.cat([torch.zeros((bsz, 1, di, n), **f32),
                   h_chunks[:, :-1].float()], 1)
    h_in = torch.empty_like(big_p)
    for q in range(segs):
        h_in[:, :, q] = h
        h = big_p[:, :, q] * h + big_b[:, :, q]
    # the adjoint's fold over all of time, in reverse
    w = torch.zeros((bsz, di, n), **f32)
    w_in = torch.empty_like(big_p)
    for k in reversed(range(nch)):
        for q in reversed(range(segs)):
            w_in[:, k, q] = w
            w = big_p[:, k, q] * w + big_g[:, k, q]
    hp, dc = [], []
    h = h_in
    for r in range(seg_len):
        hp.append(h)
        h = e[r] * h + u[r]
        dc.append((dys[:, :, :, r, :, None] * h).sum(-2))
    dx, ddt, db = [None] * seg_len, [None] * seg_len, [None] * seg_len
    da = torch.zeros((di, n), **f32)
    g = w_in
    for r in reversed(range(seg_len)):
        g = dyc[r] + (g if r == seg_len - 1 else e[r + 1] * g)
        dtt = dts[:, :, :, r, :, None]
        xt = xs[:, :, :, r, :, None]
        bt = bs[:, :, :, r, None, :]
        gdt = g * dtt
        dx[r] = (gdt * bt).sum(-1) + dys[:, :, :, r] * df
        ddt[r] = (g * (af * e[r] * hp[r] + xt * bt)).sum(-1)
        da += (gdt * e[r] * hp[r]).sum((0, 1, 2))
        db[r] = (gdt * xt).sum(-2)

    def join(parts):  # seg_len x (B, chunks, segments, C) -> (B, L, C)
        t = torch.stack(parts, 3)
        return t.reshape(bsz, nch * chunk, t.shape[-1])[:, :seq]
    dd = (dy.float() * x.float()).sum((0, 1))
    return (join(dx).to(x.dtype), join(ddt).to(dt.dtype), da, join(db),
            join(dc), dd)


def mamba_scan_plain(x, dt, a, b, c, d, return_state=False):
    """The plain version the dispatchers run: with ``return_state`` the
    sequential form's (y, h_last); otherwise the associative form up to
    ``ASSOC_MAX_LEN`` steps and the sequential one above."""
    if return_state:
        return mamba_scan_seq_stateful(x, dt, a, b, c, d)
    if x.shape[1] > ASSOC_MAX_LEN:
        return mamba_scan_seq_ref(x, dt, a, b, c, d)
    return mamba_scan_ref(x, dt, a, b, c, d)


# ------------------------------------------------------- mamba2 SSD form

def mamba2_ssd(x, dt, a, b, c, d, *, chunk: int = 128, h0=None):
    """The chunked state-space-dual (matmul) form of mamba2
    (``ref.py:174-236``), valid for a scalar decay a head.  Within a chunk
    of Q steps everything is matmuls; one (H, P, N) state crosses chunks,
    handed on by a loop over the chunks (the reference's ``lax.scan``).
    Float32 throughout.  x (B, L, H, P); dt (B, L, H) after the softplus;
    a (H,) negative; b, c (B, L, N) (one group); d (H,) → (y (B, L, H, P)
    float32, h_last (B, H, P, N) float32).  The (B, NC, Q, Q, H)
    temporaries (1.07 GB each at zamba2's 1 × 32768) are worked in place
    and freed as soon as they are used; with grad mode on (training) they
    are computed out of place, to the same bits, since autograd keeps the
    exponential's output for its backward."""
    bs, seq, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, seq)
    pad = (-seq) % q
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf, bf, cf = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                       for t in (dtf, bf, cf))
    nc = xf.shape[1] // q
    xf = xf.reshape(bs, nc, q, h, p)
    dtf = dtf.reshape(bs, nc, q, h)
    bf = bf.reshape(bs, nc, q, n)
    cf = cf.reshape(bs, nc, q, n)
    # per-chunk log-decay prefix: cum[t] = sum_{r <= t} dt_r·a  (<= 0)
    cum = torch.cumsum(dtf * a.float(), dim=2)                # (B, NC, Q, H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    m = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (B,NC,Qt,Qs,H)
    cb = torch.einsum("bktn,bksn->bkts", cf, bf)[..., None]
    if torch.is_grad_enabled():
        # Out of place, since exp's backward reads its output, and masked
        # before the exp: above the diagonal m > 0 can overflow, and inf
        # times the mask's zero gradient is NaN.  The same bits either way.
        m = torch.exp(m.masked_fill(~tri[None, None, :, :, None], -math.inf)
                      ) * cb * dtf[:, :, None, :, :]
    else:
        m.exp_().masked_fill_(~tri[None, None, :, :, None], 0.0)
        m.mul_(cb)
        m.mul_(dtf[:, :, None, :, :])
    del cb
    y = torch.einsum("bktsh,bkshp->bkthp", m, xf)            # intra-chunk
    del m
    # the state each chunk injects: sum_s exp(cum_last - cum_s)·dt_s·x_s ⊗ B_s
    wsrc = torch.exp(cum[:, :, -1:, :] - cum) * dtf           # (B, NC, Q, H)
    inj = torch.einsum("bkqhp,bkqn->bkhpn", xf * wsrc[..., None], bf)
    decay = torch.exp(cum[:, :, -1])                          # (B, NC, H)
    h_in = torch.empty_like(inj)                              # pre-chunk states
    hcur = (torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device)
            if h0 is None else h0.float())
    for k in range(nc):
        h_in[:, k] = hcur
        hcur = hcur * decay[:, k, :, None, None] + inj[:, k]
    del inj
    y += torch.einsum("bkqn,bkhpn->bkqhp", cf, h_in) * torch.exp(cum)[
        ..., None]
    del h_in
    y = y.reshape(bs, nc * q, h, p)[:, :seq]
    y = y + x.float() * d.float()[None, None, :, None]
    return y, hcur


# --------------------------------------------------------- MoE dispatch

def moe_einsum_onehot(x, w, ids, n_experts: int, cap: int, expert_ffn):
    """The reference's one-hot dispatch and combine
    (``repro/models/moe.py:64-92``), the plain version of
    ``models/moe.py``'s index form: x (B, S, d), router weights w and
    expert ids (B, S, k) → (B, S, d) in x.dtype.  Slots from the cumsum of
    the one-hot ids over the flattened (S·k) axis; a pair at or past
    ``cap`` parks on a slot the one-hot leaves empty and adds 0;
    ``expert_ffn`` maps (E, B·cap, d) → (E, B·cap, d).  Materialises
    (B, S, k, E, cap): small shapes only."""
    one_hot = torch.nn.functional.one_hot
    b, s, d = x.shape
    k = ids.shape[-1]
    dt = x.dtype
    flat = ids.reshape(b, s * k).long()
    oh = one_hot(flat, n_experts)                             # (b, sk, e)
    slot = (torch.cumsum(oh, dim=1) * oh).sum(-1) - 1         # (b, sk)
    keep = (slot >= 0) & (slot < cap)
    slot = torch.where(keep, slot, cap)                       # parked
    disp = (one_hot(flat, n_experts).to(dt)[..., :, None]
            * one_hot(slot, cap + 1)[..., :cap].to(dt)[..., None, :]
            * keep[..., None, None].to(dt))                   # (b, sk, e, c)
    disp = disp.reshape(b, s, k, n_experts, cap)
    disp_x = disp.sum(2)                                      # (b, s, e, c)
    comb = (disp * w[..., None, None].to(dt)).sum(2)
    xin = torch.einsum("bsd,bsec->ebcd", x, disp_x).reshape(
        n_experts, b * cap, d)
    hout = expert_ffn(xin).reshape(n_experts, b, cap, d)
    return torch.einsum("ebcd,bsec->bsd", hout, comb)

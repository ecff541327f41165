"""Plain PyTorch versions of the port's kernels (``kernels/csrc/*.cu``).

Twins of ``repro/kernels/ref.py``: the bit-pack functions of ``:251-294``,
the segment scatter-add of ``:240-246`` (K5), the attention functions of
``:23-123`` and the selective scans of ``:126-169`` (K9), plus the
forward with its log-sum-exp and the backward of
``repro/kernels/flash_attention.py:100-111`` and
``flash_attention_bwd.py`` (K6's LSE output and K7), and the paged decode
attention of ``repro/kernels/paged_decode.py`` (K8).  They are
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
    acc = table.to(torch.float32, copy=True)
    acc.index_add_(0, idx[keep], payload[keep].to(torch.float32))
    return acc.to(table.dtype)


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


def mamba_scan_seq_stateful(x, dt, a, b, c, d, h0=None):
    """The sequential form with its final state, the prefill's
    (``ref.py:145-164``): a loop over time, vectorised over batch, channel
    and state, in float32.  Returns (y (B, L, Di) in x.dtype, h_last
    (B, Di, N) float32); ``h0`` (B, Di, N) is the state before step 0
    (zeros when None)."""
    bsz, seq, di = x.shape
    xf, dtf = x.float(), dt.float()
    bf, cf = b.float(), c.float()
    af, df = a.float(), d.float()
    h = (torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    y = torch.empty((bsz, seq, di), dtype=torch.float32, device=x.device)
    for t in range(seq):
        dtt, xt = dtf[:, t], xf[:, t]
        h = h * torch.exp(dtt[..., None] * af) \
            + (dtt * xt)[..., None] * bf[:, t, None, :]
        y[:, t] = (h * cf[:, t, None, :]).sum(-1) + xt * df
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


def mamba_scan_plain(x, dt, a, b, c, d, return_state=False):
    """The plain version the dispatchers run: with ``return_state`` the
    sequential form's (y, h_last); otherwise the associative form up to
    ``ASSOC_MAX_LEN`` steps and the sequential one above."""
    if return_state:
        return mamba_scan_seq_stateful(x, dt, a, b, c, d)
    if x.shape[1] > ASSOC_MAX_LEN:
        return mamba_scan_seq_ref(x, dt, a, b, c, d)
    return mamba_scan_ref(x, dt, a, b, c, d)

"""Roomy paged-KV store — the RoomyArray access pattern applied to KV cache.

Port of ``repro/core/paged.py``.  The cache is an array of fixed-size
pages; a decode step's reads are delayed accesses resolved by one batched
gather per layer, and its writes one scatter — never per-token random
access.

  k_pages, v_pages : (num_pages, page_size, kv_heads, head_dim)
  page_table       : (batch, pages_per_seq) int32 — logical→physical map
  lengths          : (batch,) int32 current sequence lengths

The functions are out of place, as in the reference: ``append`` and
``bulk_fill`` return a new ``PagedKV`` and leave their argument as it was,
which the serving loop's per-slot merge relies on
(``runtime/serve_loop.py``).  ``append(..., inplace=True)`` writes into
the pages it is given instead, for a caller that donates the cache.

On a mesh each rank holds its shard of a cache (``shard_layout``: rows and
their pages over the data ranks when the batch splits over them, the
pages alone at batch 1).  A shard's ``page_table`` keeps global page ids;
the rank's first page is global page ``coordinate · P_loc``, so the local
table is ``page_table − coordinate · P_loc``.  ``make(..., shard=(i, n))``
allocates rank i's shard only; ``shard`` cuts a whole cache and
``unshard`` joins the ranks' shards back.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import device as _device
from . import sharding as SH


class PagedKV(NamedTuple):
    k_pages: torch.Tensor     # (num_pages, page, kvh, hd)
    v_pages: torch.Tensor     # (num_pages, page, kvh, hd)
    page_table: torch.Tensor  # (batch, pages_per_seq) int32
    lengths: torch.Tensor     # (batch,) int32

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[1]

    @property
    def pages_per_seq(self) -> int:
        return self.page_table.shape[1]


def identity_table(batch: int, pages_per_seq: int, device) -> torch.Tensor:
    """Page p of sequence b is physical page b·pps + p."""
    return (torch.arange(batch, device=device)[:, None] * pages_per_seq
            + torch.arange(pages_per_seq, device=device)[None, :]
            ).to(torch.int32)


def make(batch: int, max_len: int, kv_heads: int, head_dim: int,
         page_size: int = 128, dtype=torch.bfloat16, device=None,
         shard: Tuple[int, int] = (0, 1)) -> PagedKV:
    """An empty cache on ``device`` (default "cuda") under the identity
    page table; ``shard=(i, n)``: only rank i's shard of it over n data
    ranks (``shard_layout``)."""
    device = _device.resolve(device)
    pages_per_seq = -(-max_len // page_size)
    i, n = shard
    layout = shard_layout(batch, pages_per_seq, n)
    table = identity_table(batch, pages_per_seq, device)
    lengths = torch.zeros((batch,), dtype=torch.int32, device=device)
    pages, rows = _shard_slices(layout, batch, pages_per_seq, i, n)
    if layout == "rows":
        table, lengths = table[rows], lengths[rows]
    shape = (pages.stop - pages.start, page_size, kv_heads, head_dim)
    return PagedKV(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
        page_table=table, lengths=lengths)


# ------------------------------------------------------ shards on a mesh

def shard_layout(batch: int, pages_per_seq: int, n: int) -> Optional[str]:
    """How a cache of ``batch`` sequences splits over ``n`` data ranks,
    as the reference's ``cache_specs`` place it and its decode reads it:
    "rows" (batch > 1, n divides it: rank i holds rows [i·B/n, (i+1)·B/n),
    their pages under the batch-major identity table, and those rows of
    the table and lengths); "pages" (batch 1, n divides the pages: rank i
    holds pages [i·P/n, (i+1)·P/n), the table and length whole); None
    (the whole cache on every rank)."""
    if batch > 1 and batch % n == 0:
        return "rows"
    if batch == 1 and pages_per_seq % n == 0:
        return "pages"
    return None


def _shard_slices(layout, batch, pages_per_seq, i, n):
    """(pages, rows) slices of rank i's shard under ``layout``."""
    total = batch * pages_per_seq
    if layout is None:
        return slice(0, total), slice(0, batch)
    per = total // n
    rows = batch // n if layout == "rows" else batch
    return (slice(i * per, (i + 1) * per),
            slice(i * rows, (i + 1) * rows) if layout == "rows"
            else slice(0, batch))


def shard(cache: PagedKV, i: int, n: int) -> PagedKV:
    """Rank i's shard of a whole cache over n data ranks (views)."""
    b, pps = cache.page_table.shape
    layout = shard_layout(b, pps, n)
    pages, rows = _shard_slices(layout, b, pps, i, n)
    return PagedKV(cache.k_pages[pages], cache.v_pages[pages],
                   cache.page_table[rows], cache.lengths[rows])


def unshard(shards: List[PagedKV], batch: int) -> PagedKV:
    """The whole cache of ``batch`` sequences from every rank's shard, in
    coordinate order."""
    first = shards[0]
    layout = shard_layout(batch, first.pages_per_seq, len(shards))
    if layout is None:
        return first
    cat = lambda f: torch.cat([getattr(s, f) for s in shards])  # noqa: E731
    rows = layout == "rows"
    return PagedKV(cat("k_pages"), cat("v_pages"),
                   cat("page_table") if rows else first.page_table,
                   cat("lengths") if rows else first.lengths)


def gather_pages(cache: PagedKV, mesh, axes) -> PagedKV:
    """The whole cache on every rank from its page shards over ``axes``
    (the batch-1 layout: an all-gather of the pages)."""
    return cache._replace(k_pages=SH.gather_leading(cache.k_pages, mesh, axes),
                          v_pages=SH.gather_leading(cache.v_pages, mesh, axes))


def own_shard(cache: PagedKV, mesh, axes) -> PagedKV:
    """This rank's shard of a whole cache, copied out of it."""
    mine = shard(cache, SH.axis_index(mesh, axes), SH.axis_size(mesh, axes))
    return PagedKV(*(t.clone() for t in mine))


def append(cache: PagedKV, k_new: torch.Tensor, v_new: torch.Tensor, *,
           inplace: bool = False) -> PagedKV:
    """Append one token's K/V per sequence (decode step).

    k_new, v_new: (batch, kv_heads, head_dim).  The whole batch of writes
    lands as one scatter (Roomy update + sync).  A sequence already past
    its last page has its write dropped and its length still advanced, as
    in the reference (an out-of-range page lookup, then a dropped scatter);
    here it writes its last page's current value back in place, so no
    host synchronisation is needed to find it.  With ``inplace`` the rows
    are written into ``cache``'s own pages, which the result shares (the
    caller donates the cache: no copy of the pages); ``cache.lengths`` is
    left as it was either way."""
    lengths = cache.lengths.long()
    page_logical = lengths // cache.page_size
    offset = lengths % cache.page_size
    inside = (page_logical < cache.pages_per_seq)[:, None, None]
    page_logical = page_logical.clamp(max=cache.pages_per_seq - 1)
    phys = cache.page_table.long().gather(1, page_logical[:, None])[:, 0]

    def write(pages, new):
        new = torch.where(inside, new.to(pages.dtype), pages[phys, offset])
        if inplace:
            return pages.index_put_((phys, offset), new)
        return pages.index_put((phys, offset), new)
    return cache._replace(k_pages=write(cache.k_pages, k_new),
                          v_pages=write(cache.v_pages, v_new),
                          lengths=cache.lengths + 1)


def bulk_fill(cache: PagedKV, k: torch.Tensor, v: torch.Tensor,
              lengths: torch.Tensor) -> PagedKV:
    """Prefill: write (batch, seq, kvh, hd) K/V into pages in one pass.

    Partial final pages are zero-padded (lengths marks validity)."""
    b, s, kvh, hd = k.shape
    ps = cache.page_size
    npage = -(-s // ps)
    pad = npage * ps - s
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    phys = cache.page_table[:, :npage].reshape(-1).long()
    k_pages = cache.k_pages.index_put(
        (phys,), k.reshape(b * npage, ps, kvh, hd).to(cache.k_pages.dtype))
    v_pages = cache.v_pages.index_put(
        (phys,), v.reshape(b * npage, ps, kvh, hd).to(cache.v_pages.dtype))
    return cache._replace(k_pages=k_pages, v_pages=v_pages,
                          lengths=lengths.to(torch.int32))


def gather(cache: PagedKV) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Resolve the delayed page accesses for a decode step.

    Returns (k, v, mask): (batch, pages_per_seq·page, kvh, hd) and a
    validity mask (batch, pages_per_seq·page) — one batched gather, the
    page table as the op queue."""
    b, pps = cache.page_table.shape
    ps = cache.page_size
    table = cache.page_table.long()
    k = cache.k_pages[table].reshape(b, pps * ps, *cache.k_pages.shape[2:])
    v = cache.v_pages[table].reshape(b, pps * ps, *cache.v_pages.shape[2:])
    mask = (torch.arange(pps * ps, device=table.device)[None, :]
            < cache.lengths[:, None])
    return k, v, mask

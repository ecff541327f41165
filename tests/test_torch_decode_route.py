"""K8's two routes and K9's launch geometry, in pure Python.

``repro_torch.kernels.paged_decode.route`` sends a call to the TMA kernel
(a ring of K/V tiles loaded by TMA through the page table, mma.sync
products, the splits merged in the same launch) or to the classic kernels
from dtype, head dim, page size and alignment alone, before launch;
``tma_geometry`` turns a page pool into the 4-D tensor map the TMA loads
read and ``tma_splits`` is the split plan; ``tma_tiles`` here is the
producer's walk of one split, as ``pd_hopper_kernel`` computes it.  None needs a card: the pools here are CPU tensors of
the models' layouts.  A TMA box load is emulated over the pool's storage
(the element at coordinates (c0, c1, c2, c3) lives at byte c0·2 + c1·s1 +
c2·s2 + c3·s3; a coordinate past its dim reads zero) and compared with the
pool itself, so the dims and strides are the pool's and a box never reads
into the next kv head or page.  The walk, run as flash-decoding in float32
(partials per split in log2 units, merged in the kernel's order), is held
to the plain version.  ``mamba_scan.geometry`` is K9's launch: it must
cover every channel, state and step, tails included.  The kernels
themselves are held to their plain versions on the card by
``chip_smoke.py``.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import mamba_scan as tms
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_decode as tpd
from repro_torch.kernels import ref as tref
from repro_torch.models import lm

BF16 = torch.bfloat16
PS = lm.PAGE_SIZE

# name: (Hq, kvh, hd) of a model's decode layer
MODELS = {
    "gemma2-2b": (8, 4, 256),         # group 2, softcap 50
    "nemotron-4-15b": (48, 8, 128),   # group 6
    "granite-34b": (48, 1, 128),      # group 48: three m-tiles
    "minicpm-2b": (36, 36, 64),       # group 1
}
SLOTS = 132 * 2                        # an H100's SMs x two blocks an SM


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pool(pages, ps, kvh, hd, dtype=BF16):
    return torch.zeros((pages, ps, kvh, hd), dtype=dtype)


def _misaligned(shape, dtype=BF16):
    """A contiguous tensor whose base lies 2 bytes past a 16-byte line."""
    n = int(np.prod(shape))
    flat = torch.zeros(n + 16, dtype=dtype)
    off = (-flat.data_ptr() % 16) // flat.element_size() + 1
    return flat[off:off + n].view(shape)


# ------------------------------------------------------------- K8: route

@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("ps", [PS, 64, 256])
def test_model_layouts_take_the_tma_route(model, ps):
    hq, kvh, hd = MODELS[model]
    q = torch.zeros((2, hq, hd), dtype=BF16)
    kp, vp = _pool(5, ps, kvh, hd), _pool(5, ps, kvh, hd)
    assert tpd.route(q, kp, vp) == "tma"


@pytest.mark.parametrize("model", sorted(MODELS))
def test_float32_takes_the_classic_route(model):
    hq, kvh, hd = MODELS[model]
    q = torch.zeros((2, hq, hd))
    kp = _pool(5, PS, kvh, hd, torch.float32)
    assert tpd.route(q, kp, kp.clone()) == "classic"


@pytest.mark.parametrize("hd", [12, 16, 32, 100])
def test_the_smoke_head_dims_take_the_classic_route(hd):
    q = torch.zeros((2, 4, hd), dtype=BF16)
    kp = _pool(5, PS, 2, hd)
    assert tpd.route(q, kp, kp.clone()) == "classic"


@pytest.mark.parametrize("ps", [8, 16, 32, 96, 100])
def test_pages_of_no_whole_tile_take_the_classic_route(ps):
    q = torch.zeros((2, 12, 128), dtype=BF16)
    kp = _pool(5, ps, 2, 128)
    assert tpd.route(q, kp, kp.clone()) == "classic"


@pytest.mark.parametrize("which", [0, 1])
def test_misaligned_or_strided_pools_take_the_classic_route(which):
    q = torch.zeros((2, 12, 128), dtype=BF16)
    pools = [_pool(5, PS, 2, 128), _pool(5, PS, 2, 128)]
    pools[which] = _misaligned((5, PS, 2, 128))
    assert pools[which].data_ptr() % 16 != 0
    assert tpd.route(q, *pools) == "classic"
    pools = [_pool(5, PS, 2, 128), _pool(5, PS, 2, 128)]
    pools[which] = _pool(5, PS, 4, 128)[:, :, :2]      # a kv-head view
    assert not pools[which].is_contiguous()
    # a tensor-parallel decode reads its kv-head view of the cache in
    # place: the TMA map takes the view's strides, so an aligned view takes
    # the TMA route; a misaligned one still the classic route
    assert tpd.route(q, *pools) == "tma"
    pools[which] = _misaligned((5, PS, 4, 128))[:, :, 1:3]
    assert not pools[which].is_contiguous()
    assert tpd.route(q, *pools) == "classic"


def test_an_empty_pool_takes_the_classic_route():
    q = torch.zeros((1, 12, 128), dtype=BF16)
    kp = _pool(0, PS, 2, 128)
    assert tpd.route(q, kp, kp.clone()) == "classic"


# -------------------------------------------------------- K8: tensor map

@pytest.mark.parametrize("model", sorted(MODELS))
def test_geometry_follows_the_pool(model):
    _, kvh, hd = MODELS[model]
    kp = _pool(7, PS, kvh, hd)
    g = tpd.tma_geometry(kp)
    dims, strides, box = g[:4], g[4:7], g[7:]
    assert dims == (hd, kvh, PS, 7)
    assert strides == tuple(2 * s for s in kp.stride()[2::-1])
    assert all(s % 16 == 0 for s in strides)          # TMA's stride rule
    assert box == (tpd.TMA_BOX_COLS, 1, tpd.TMA_TILE, 1)
    assert box[0] * kp.element_size() == 128          # one swizzle row
    assert hd % box[0] == 0 and PS % box[2] == 0      # whole boxes tile it


def _tma_box(storage, g, coords):
    """What a TMA load of one box reads: ``storage`` holds the pool's
    elements by element offset, ``g`` is ``tma_geometry``'s tuple; zero
    outside the dims (the map's out-of-bounds fill)."""
    d0, d1, d2, d3, s1, s2, s3, b0, b1, b2, b3 = g
    c0, c1, c2, c3 = coords
    i3, i2, i1, i0 = np.meshgrid(np.arange(b3), np.arange(b2), np.arange(b1),
                                 np.arange(b0), indexing="ij")
    col, head, tok, page = c0 + i0, c1 + i1, c2 + i2, c3 + i3
    inside = (col < d0) & (head < d1) & (tok < d2) & (page < d3)
    byte = 2 * col + head * s1 + tok * s2 + page * s3
    return np.where(inside, storage[np.where(inside, byte // 2, 0)], 0)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_emulated_boxes_read_one_head_of_one_page(model):
    _, kvh, hd = MODELS[model]
    kvh = min(kvh, 3)          # keep the emulation small
    pages, ps = 3, 2 * tpd.TMA_TILE
    # element ids, 1-based so that the zero fill stands apart
    ids = torch.arange(1, pages * ps * kvh * hd + 1, dtype=torch.int64)
    pool = ids.view(pages, ps, kvh, hd)
    storage = pool.reshape(-1).numpy()
    g = tpd.tma_geometry(torch.empty(pool.shape, dtype=BF16))
    want = pool.numpy()
    for page in range(pages):
        for head in {0, kvh - 1}:
            for t0 in range(0, ps, tpd.TMA_TILE):
                for c0 in range(0, hd, tpd.TMA_BOX_COLS):
                    box = _tma_box(storage, g, (c0, head, t0, page))
                    box = box[0, :, 0, :]                  # (tokens, cols)
                    np.testing.assert_array_equal(
                        box, want[page, t0:t0 + tpd.TMA_TILE, head,
                                  c0:c0 + tpd.TMA_BOX_COLS])
                    got = box.ravel() - 1
                    assert (got // hd % kvh == head).all()
                    assert (got // (hd * kvh * ps) == page).all()
    # a box that would run past the page reads zeros, not the next page
    past = _tma_box(storage, g, (0, 0, ps - tpd.TMA_TILE // 2, 0))[0, :, 0]
    assert past[tpd.TMA_TILE // 2:].sum() == 0
    assert (past[:tpd.TMA_TILE // 2].ravel() - 1 < hd * kvh * ps).all()


# ------------------------------------------------------- K8: split plan

def split_pages(npages: int, splits: int, split: int) -> range:
    """The pages [pg0, pg1) of a row with ``npages`` live pages that split
    ``split`` of ``splits`` walks, as both kernels of
    ``csrc/paged_decode.cu`` compute it from the row's length on the
    card."""
    per = -(-npages // splits) if npages else 0
    pg0 = min(npages, split * per)
    return range(pg0, min(npages, pg0 + per))


def tma_tiles(table_row, length: int, ps: int, pps: int, num_pages: int,
              splits: int, split: int) -> list:
    """The tiles the TMA route's producer issues for one (batch row,
    split), in order: (physical page, first token in the page, live
    tokens), as ``pd_hopper_kernel`` walks them.  Entries at or past the
    length are never read; an entry outside [0, P) is skipped."""
    n = max(0, min(int(length), pps * ps))
    tiles = []
    for pg in split_pages(-(-n // ps), splits, split):
        phys = int(table_row[pg])
        if not 0 <= phys < num_pages:
            continue
        valid = min(ps, n - pg * ps)
        tiles += [(phys, t0, min(tpd.TMA_TILE, valid - t0))
                  for t0 in range(0, valid, tpd.TMA_TILE)]
    return tiles


def _ragged(b, pps, ps, rng):
    """Lengths 1, ps, ps + 1, 63, 65, the whole table and 0 first, then
    random ones."""
    fixed = [1, ps, ps + 1, 63, 65, pps * ps, 0]
    return np.asarray(fixed[:b] + list(rng.integers(1, pps * ps + 1,
                                                    max(0, b - 7))))


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("batch,pps", [(1, 257), (8, 257), (5, 3), (11, 40)])
def test_split_plan_is_a_function_of_the_shapes(model, batch, pps):
    hq, kvh, hd = MODELS[model]
    g = hq // kvh
    s = tpd.tma_splits(batch, kvh, g, pps, PS, SLOTS)
    assert s == tpd.tma_splits(batch, kvh, g, pps, PS, SLOTS)
    assert 1 <= s <= min(pps, tpd.TMA_MAX_SPLITS)
    assert s <= max(1, math.isqrt(pps * PS // 16))      # the merge stays small
    per = -(-pps // s)
    blocks = batch * kvh * -(-g // tpd.TMA_ROWS)
    # pages a split are bounded, or one wave of blocks is already full
    assert per <= tpd.TMA_MAX_PAGES or blocks * s >= SLOTS or \
        s == max(1, math.isqrt(pps * PS // 16))


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("batch,pps", [(1, 257), (8, 40), (9, 3)])
def test_every_live_token_is_walked_exactly_once(model, batch, pps):
    hq, kvh, hd = MODELS[model]
    rng = np.random.default_rng(batch * pps)
    num_pages = batch * pps + 5
    table = rng.permutation(num_pages)[:batch * pps].reshape(batch, pps)
    lengths = _ragged(batch, pps, PS, rng)
    # garbage past each length: never to be read
    live = -(-np.clip(lengths, 0, pps * PS) // PS)
    junk = np.array([-7, 10 ** 6, 2 ** 31 - 1, -2 ** 31])
    cols = np.arange(pps)[None, :]
    table = np.where(cols >= live[:, None], junk[cols % 4], table)
    s = tpd.tma_splits(batch, kvh, hq // kvh, pps, PS, SLOTS)
    for row in range(batch):
        seen = []
        for split in range(s):
            for phys, t0, nt in tma_tiles(table[row], lengths[row], PS,
                                               pps, num_pages, s, split):
                assert 0 <= phys < num_pages
                assert t0 % tpd.TMA_TILE == 0 and 1 <= nt <= tpd.TMA_TILE
                assert t0 + nt <= PS
                seen += [(phys, t0 + i) for i in range(nt)]
        n = int(min(lengths[row], pps * PS))
        want = [(int(table[row, t // PS]), t % PS) for t in range(n)]
        assert sorted(seen) == sorted(want)
        assert len(seen) == len(set(seen))


def test_an_entry_outside_the_pool_is_skipped():
    table = np.array([3, -1, 9, 0])
    tiles = tma_tiles(table, 4 * PS, PS, 4, 5, 1, 0)
    assert {t[0] for t in tiles} == {3, 0}


def _emulate_tma(q, kp, vp, table, lengths, softcap, splits):
    """The TMA route's arithmetic in float32 on the CPU: each split's
    online softmax over its tiles in log2 units, then the merge of the
    splits' (m, l, acc) in their order, as ``pd_hopper_kernel``."""
    b, hq, hd = q.shape
    num_pages, ps, kvh, _ = kp.shape
    g, pps = hq // kvh, table.shape[1]
    scale = 1.0 / math.sqrt(hd)
    out = torch.zeros((b, hq, hd))
    for bi in range(b):
        for h in range(kvh):
            qg = q[bi, h * g:(h + 1) * g].float()
            parts = []
            for split in range(splits):
                m = torch.full((g,), tref.NEG_INF)
                l, acc = torch.zeros(g), torch.zeros((g, hd))
                for phys, t0, nt in tma_tiles(
                        table[bi], int(lengths[bi]), ps, pps, num_pages,
                        splits, split):
                    k = kp[phys, t0:t0 + nt, h].float()
                    v = vp[phys, t0:t0 + nt, h].float()
                    s = qg @ k.T * scale
                    if softcap is not None:
                        s = torch.tanh(s / softcap) * softcap
                    s = s * math.log2(math.e)
                    mx = torch.maximum(m, s.max(-1).values)
                    p = torch.exp2(s - mx[:, None])
                    alpha = torch.exp2(m - mx)
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + p @ v
                    m = mx
                parts.append((m, l, acc))
            mx = torch.stack([p[0] for p in parts]).max(0).values
            w = [torch.exp2(p[0] - mx) for p in parts]
            lsum = sum(wi * p[1] for wi, p in zip(w, parts))
            tot = sum(wi[:, None] * p[2] for wi, p in zip(w, parts))
            out[bi, h * g:(h + 1) * g] = tot / torch.where(
                lsum == 0, 1.0, lsum)[:, None]
    return out


@pytest.mark.parametrize("model", sorted(MODELS))
def test_the_walk_as_flash_decoding_matches_the_plain_version(model):
    hq, kvh, hd = MODELS[model]
    kvh, hq = min(kvh, 2), min(kvh, 2) * (hq // kvh)
    b, ps, pps = 7, tpd.TMA_TILE * 2, 3
    rng = np.random.default_rng(7)
    num_pages = b * pps + 2
    kp = torch.from_numpy(rng.standard_normal((num_pages, ps, kvh, hd),
                                              np.float32))
    vp = torch.from_numpy(rng.standard_normal((num_pages, ps, kvh, hd),
                                              np.float32))
    q = torch.from_numpy(rng.standard_normal((b, hq, hd), np.float32))
    table = torch.from_numpy(rng.permutation(num_pages)[:b * pps]
                             .reshape(b, pps).astype(np.int32))
    lengths = torch.from_numpy(_ragged(b, pps, ps, rng).astype(np.int32))
    cap = 50.0 if model == "gemma2-2b" else None
    want = tref.paged_decode_attention_ref(q, kp, vp, table, lengths,
                                           softcap=cap)
    for splits in (1, 2, tpd.tma_splits(b, kvh, hq // kvh, pps, ps, SLOTS)):
        got = _emulate_tma(q, kp, vp, table.numpy(), lengths, cap, splits)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                                   rtol=2e-5)
    assert not want[lengths == 0].any()


def test_cpu_calls_take_no_route_and_book_nothing():
    hq, kvh, hd = MODELS["nemotron-4-15b"]
    rng = np.random.default_rng(3)
    kp = torch.from_numpy(rng.standard_normal((4, PS, kvh, hd),
                                              np.float32)).to(BF16)
    q = torch.from_numpy(rng.standard_normal((1, hq, hd),
                                             np.float32)).to(BF16)
    table = torch.tensor([[2, 0]], dtype=torch.int32)
    lengths = torch.tensor([PS + 3], dtype=torch.int32)
    assert tpd.route(q, kp, kp) == "tma"
    routes, launches = dict(tpd.ROUTE_LAUNCHES), dict(tpd.LAUNCHES)
    got = tops.paged_decode_attention(q, kp, kp, table, lengths)
    want = tref.paged_decode_attention_ref(q, kp, kp, table, lengths)
    assert torch.equal(got, want)
    assert dict(tpd.ROUTE_LAUNCHES) == routes
    assert dict(tpd.LAUNCHES) == launches


# --------------------------------------------------------- K9: geometry

# name: (B, L, Di, N)
SCANS = {
    "falcon-mamba-7b": (1, 32768, 8192, 16),
    "falcon-mamba-7b SMOKE": (2, 300, 64, 4),
    "zamba2 (N 64)": (1, 4100, 5120, 64),
    "ragged": (2, 37, 100, 3),
    "one step": (1, 1, 8192, 16),
}


@pytest.mark.parametrize("name", sorted(SCANS))
def test_scan_geometry_covers_every_channel_state_and_step(name):
    b, l, di, n = SCANS[name]
    g = tms.geometry(b, l, di, n)
    tpc, ch = g["tpc"], g["channels"]
    assert tpc & (tpc - 1) == 0 and tpc <= 16          # the kernel's cases
    assert g["states"] == tpc * tms.SPT >= n
    assert tpc == 1 or (tpc // 2) * tms.SPT < n         # no spare group
    assert ch * tpc == tms.LANES
    assert g["grid"] == (-(-di // ch), b)
    assert g["grid"][0] * ch >= di > (g["grid"][0] - 1) * ch
    assert g["threads"] == tms.LANES * tms.SEGMENTS
    assert tms.CHUNK == tms.SEGMENTS * tms.SEG_LEN
    assert g["chunks"] * tms.CHUNK >= l > (g["chunks"] - 1) * tms.CHUNK
    # the block's static shared memory (csrc/mamba_scan.cu): x, dt, b, c
    # of a chunk, the segment maps and the parts of y
    smem = 4 * (2 * tms.CHUNK * ch + 2 * tms.CHUNK * g["states"]
                + 2 * tms.SEGMENTS * tms.LANES * tms.SPT
                + tms.CHUNK * tms.LANES)
    assert smem <= 48 * 1024 and tms.BLOCKS_PER_SM * smem <= 228 * 1024


def test_falcon_mamba_fills_the_card():
    g = tms.geometry(*SCANS["falcon-mamba-7b"])
    blocks = g["grid"][0] * g["grid"][1]
    slots = 132 * tms.BLOCKS_PER_SM
    assert blocks == 512 and 0.95 < blocks / (2 * slots) <= 1   # two waves
    assert tms.BLOCKS_PER_SM * g["threads"] // 32 == 16         # warps an SM


def test_ticket_buffers_are_per_stream():
    """K8's TMA route takes its merge tickets from a buffer keyed by
    (device, stream): two streams never share one, one stream keeps its
    buffer, and a larger need gives that stream a larger zeroed one."""
    dev = torch.device("cpu")
    a = tpd._counters(dev, 11, 8)
    b = tpd._counters(dev, 12, 8)
    assert a.data_ptr() != b.data_ptr()
    assert tpd._counters(dev, 11, 8) is a
    assert tpd._counters("cpu", 11, 1024) is a
    big = tpd._counters(dev, 12, 5000)
    assert big.numel() >= 5000 and not big.any()
    assert big.data_ptr() != a.data_ptr()
    assert tpd._counters(dev, 11, 8) is a
    for key in [(dev, 11), (dev, 12)]:
        del tpd._COUNTERS[key]

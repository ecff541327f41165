"""K6's and K7's two routes and the Hopper routes' TMA geometry, in pure Python.

``repro_torch.kernels.flash_attention.route`` sends a call to the wgmma
kernel (TMA loads into a ring, warp specialisation) or to the classic
kernels from dtype, shape, strides and alignment alone, before launch;
``tma_geometry`` turns a (B, H, S, D) view into the 4-D tensor map the
wgmma kernel's TMA loads read.  K7's ``flash_attention_bwd.route`` does
the same for the backward, with dO beside q, k, v and o, and
``tma_maps`` gives its two kernels' maps.  Neither needs a card: the
layouts here are CPU tensors with the models' strides, and dO is the one
autograd hands the backward.  A TMA box load is emulated over the view's
storage (the element at coordinates (c0, c1, c2, c3) lives at byte
c0·2 + c1·stride_S + c2·stride_H + c3·stride_B; a row past S reads zero)
and compared with the view itself, so the dims and byte strides are the
view's and a tile never reads into the next head.  The kernels are held
to their plain versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_attention_bwd as tfab
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

BF16 = torch.bfloat16

# name: (B, S, Hq, Hkv, D) of a model's (B, S, H, D) activations
MODELS = {
    "gemma2-2b": (1, 40, 8, 4, 256),        # GQA 2
    "nemotron-4-15b": (1, 40, 48, 8, 128),  # group 6
    "granite-34b": (1, 40, 48, 1, 128),     # group 48
    "minicpm-2b": (2, 40, 36, 36, 64),      # MHA 36
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One CPU thread: the bit-for-bit CPU checks then add in one order, and
    tiny tensors lose more to torch's thread pool than they gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _views(b, s, hq, hkv, d, dtype=BF16):
    """q, k, v as the model passes them: (B, S, H, D) activations viewed
    as (B, H, S, D); and the output the wrapper allocates."""
    q = torch.zeros((b, s, hq, d), dtype=dtype).transpose(1, 2)
    k = torch.zeros((b, s, hkv, d), dtype=dtype).transpose(1, 2)
    v = torch.zeros((b, s, hkv, d), dtype=dtype).transpose(1, 2)
    return q, k, v, torch.empty_like(q)


def _misaligned(shape, dtype=BF16):
    """A contiguous tensor whose base lies 2 bytes past a 16-byte line."""
    n = int(np.prod(shape))
    flat = torch.zeros(n + 8, dtype=dtype)
    if flat.data_ptr() % 16 == 0:
        return flat[1:n + 1].view(shape)
    off = (16 - flat.data_ptr() % 16) // flat.element_size() + 1
    return flat[off:off + n].view(shape)


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("layout", ["strided", "contiguous"])
def test_model_layouts_take_the_wgmma_route(model, layout):
    b, s, hq, hkv, d = MODELS[model]
    q, k, v, o = _views(b, s, hq, hkv, d)
    if layout == "contiguous":
        q, k, v, o = (x.contiguous() for x in (q, k, v, o))
    assert o.stride() == q.stride()
    assert tfa.route(q, k, v, o) == "wgmma"


@pytest.mark.parametrize("d", [12, 16, 32, 100])
def test_other_head_dims_take_the_classic_route(d):
    assert tfa.route(*_views(1, 40, 4, 2, d)) == "classic"


@pytest.mark.parametrize("d", [64, 128, 256])
def test_float32_takes_the_classic_route(d):
    assert tfa.route(*_views(1, 40, 4, 2, d, torch.float32)) == "classic"


@pytest.mark.parametrize("which", [0, 1, 2, 3])
def test_a_misaligned_base_takes_the_classic_route(which):
    xs = list(_views(1, 40, 4, 2, 128))
    xs[which] = _misaligned(tuple(xs[which].shape))
    assert xs[which].data_ptr() % 16 != 0
    assert tfa.route(*xs) == "classic"


@pytest.mark.parametrize("which", [0, 1, 2])
def test_a_stride_off_the_16_byte_rule_takes_the_classic_route(which):
    xs = list(_views(1, 40, 4, 2, 64))
    b, h, s, d = xs[which].shape
    # rows of 68 elements (136 bytes) with the head dim's 64 in front
    wide = torch.zeros((b, s, h, d + 4), dtype=BF16)[..., :d]
    xs[which] = wide.transpose(1, 2)
    assert xs[which].stride(1) % 8 != 0
    assert tfa.route(*xs) == "classic"


def test_broadcast_kv_heads_and_empty_keys_take_the_classic_route():
    q, k, v, o = _views(1, 40, 8, 1, 128)
    kb, vb = k.expand(1, 8, 40, 128), v.expand(1, 8, 40, 128)
    assert kb.stride(1) == 0
    assert tfa.route(q, kb, vb, o) == "classic"
    k0 = torch.zeros((1, 1, 0, 128), dtype=BF16)
    assert tfa.route(q, k0, k0, o) == "classic"


@pytest.mark.parametrize("model", sorted(MODELS))
def test_geometry_follows_the_view(model):
    b, s, hq, hkv, d = MODELS[model]
    q, k, _, _ = _views(b, s, hq, hkv, d)
    bq, bk = tfa.TMA_TILES[d]
    for x, rows in ((q, bq), (k, bk)):
        g = tfa.tma_geometry(x, rows)
        dims, strides, box = g[:4], g[4:7], g[7:]
        assert dims == (d, s, x.shape[1], b)
        for n, st, want in zip(dims[1:], strides,
                               (x.stride(2), x.stride(1), x.stride(0))):
            assert st % 16 == 0
            if n > 1:
                assert st == 2 * want
        assert box == (tfa.TMA_BOX_COLS, rows, 1, 1)
        assert box[0] * x.element_size() <= 128   # one 128-byte swizzle row
        assert d % box[0] == 0                    # whole boxes span D
        assert box[2] == 1 and box[3] == 1        # one head, one batch row


@pytest.mark.parametrize("d", sorted(tfa.TMA_TILES))
def test_tiles_fit_the_wgmma_shapes(d):
    bq, bk = tfa.TMA_TILES[d]
    assert bq == 128                  # two consumer warpgroups of 64 rows
    assert bk % 16 == 0               # wgmma's n, and whole k16 steps
    assert bk <= 256 and bq <= 256    # wgmma's n and TMA's box extents


def _tma_box(storage, g, coords):
    """What a TMA load of one box reads: ``storage`` holds the view's
    elements by element offset, ``g`` is ``tma_geometry``'s tuple; zero
    outside the dims (the map's out-of-bounds fill)."""
    d, s, h, b, ss, sh, sb, bc, br, bh, bb = g
    c0, c1, c2, c3 = coords
    i3, i2, i1, i0 = np.meshgrid(np.arange(bb), np.arange(bh), np.arange(br),
                                 np.arange(bc), indexing="ij")
    col, row, head, bat = c0 + i0, c1 + i1, c2 + i2, c3 + i3
    inside = (col < d) & (row < s) & (head < h) & (bat < b)
    byte = 2 * col + row * ss + head * sh + bat * sb
    return np.where(inside, storage[np.where(inside, byte // 2, 0)], 0)


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("layout", ["strided", "contiguous"])
def test_emulated_boxes_read_the_view_and_never_cross_a_head(model, layout):
    b, s, hq, hkv, d = MODELS[model]
    # keep the head count and row count small enough for the emulation
    hq, s = min(hq, 6), 70
    # element ids, 1-based so that the zero fill stands apart
    ids = torch.arange(1, b * s * hq * d + 1, dtype=torch.int64)
    act = ids.view(b, s, hq, d)
    view = act.transpose(1, 2)
    if layout == "contiguous":
        view = view.contiguous()
    storage = torch.as_strided(view, (view.numel(),), (1,),
                               view.storage_offset()).numpy()
    geom_src = torch.empty_strided(view.shape, view.stride(), dtype=BF16)
    rows = tfa.TMA_TILES[d][1]
    g = tfa.tma_geometry(geom_src, rows)
    want = view.numpy()
    for bat in range(b):
        for head in (0, view.shape[1] - 1):
            for c1 in range(0, s, rows):                 # every kv tile
                for c0 in range(0, d, tfa.TMA_BOX_COLS):  # every box of D
                    box = _tma_box(storage, g, (c0, c1, head, bat))[0, 0]
                    n = min(rows, s - c1)
                    np.testing.assert_array_equal(
                        box[:n], want[bat, head, c1:c1 + n,
                                      c0:c0 + tfa.TMA_BOX_COLS])
                    assert not box[n:].any()   # past S: zeros, not a head
                    # every id read belongs to this head and batch row
                    got = box[:n].ravel() - 1
                    assert (got // d % hq == head).all()
                    assert (got // (d * hq * s) == bat).all()


def test_cpu_calls_take_no_route_and_book_nothing():
    q, k, v, _ = _views(1, 40, 8, 4, 256)
    q, k, v = (torch.randn(x.shape).to(BF16) for x in (q, k, v))
    routes, launches = dict(tfa.ROUTE_LAUNCHES), dict(tfa.LAUNCHES)
    got = tops.flash_attention(q, k, v, softcap=50.0)
    want = tref.attention_ref(q, k, v, softcap=50.0)
    assert torch.equal(got, want)
    assert dict(tfa.ROUTE_LAUNCHES) == routes
    assert dict(tfa.LAUNCHES) == launches


def test_reset_launches_clears_the_route_counter():
    tfa.ROUTE_LAUNCHES["wgmma"] += 3
    tfa.reset_launches()
    assert dict(tfa.ROUTE_LAUNCHES) == {"wgmma": 0, "classic": 0}
    assert not any(tfa.LAUNCHES.values())


# ------------------------------------------------------------- K7's routes

def _autograd_bwd_args(b, s, hq, hkv, d, layout, monkeypatch):
    """q, k, v, o, lse, dO as the autograd Function hands them to K7's
    wrapper when the model runs attention on (B, S, H, D) activations
    (``models/attention.py``: heads moved to dim 1 by a transpose, the
    output moved back and flattened into a projection); o as the CUDA
    wrapper allocates it, ``torch.empty_like(q)``."""
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal((b, s, h, d), np.float32))
          .to(BF16).requires_grad_(True) for h in (hq, hkv, hkv)]
    q, k, v = (x.transpose(1, 2) for x in xs)
    if layout == "contiguous":
        q, k, v = (x.contiguous() for x in (q, k, v))
    seen = {}

    def record(*args, **kw):
        seen["args"] = args
        return tref.flash_attention_bwd_ref(*args, **kw)
    monkeypatch.setattr(tops._fab, "flash_attention_bwd", record)
    out = tops.flash_attention(q, k, v, softcap=50.0)
    flat = out.transpose(1, 2).reshape(b, s, hq * d)
    w = torch.from_numpy(rng.standard_normal((hq * d, 8), np.float32))
    (flat.float() @ w).sum().backward()
    q, k, v, _, lse, do = seen["args"]
    return q, k, v, torch.empty_like(q), lse, do


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("layout", ["strided", "contiguous"])
def test_bwd_model_layouts_take_the_wgmma_route(model, layout, monkeypatch):
    q, k, v, o, _, do = _autograd_bwd_args(*MODELS[model], layout,
                                           monkeypatch)
    assert do.shape == q.shape and do.dtype == BF16
    assert tfab.route(q, k, v, o, do) == "wgmma"
    assert len(tfab.tma_maps(q, k, v, do)) == 8 * 11


@pytest.mark.parametrize("d", [12, 16, 32, 100])
def test_bwd_other_head_dims_take_the_classic_route(d):
    q, k, v, o = _views(1, 40, 4, 2, d)
    assert tfab.route(q, k, v, o, torch.zeros_like(q)) == "classic"


@pytest.mark.parametrize("d", [64, 128, 256])
def test_bwd_float32_takes_the_classic_route(d):
    q, k, v, o = _views(1, 40, 4, 2, d, torch.float32)
    assert tfab.route(q, k, v, o, torch.zeros_like(q)) == "classic"


@pytest.mark.parametrize("which", ["q", "k", "v", "o", "do"])
def test_bwd_a_misaligned_base_takes_the_classic_route(which):
    q, k, v, o = _views(1, 40, 4, 2, 128)
    xs = dict(q=q, k=k, v=v, o=o, do=torch.zeros_like(q))
    xs[which] = _misaligned(tuple(xs[which].shape))
    assert xs[which].data_ptr() % 16 != 0
    assert tfab.route(**xs) == "classic"


@pytest.mark.parametrize("which", ["q", "k", "v", "o", "do"])
def test_bwd_a_stride_off_the_16_byte_rule_takes_the_classic_route(which):
    q, k, v, o = _views(1, 40, 4, 2, 64)
    xs = dict(q=q, k=k, v=v, o=o, do=torch.zeros_like(q))
    b, h, s, d = xs[which].shape
    # rows of 68 elements (136 bytes) with the head dim's 64 in front
    xs[which] = torch.zeros((b, s, h, d + 4), dtype=BF16)[..., :d] \
        .transpose(1, 2)
    assert xs[which].stride(1) % 8 != 0
    assert tfab.route(**xs) == "classic"


@pytest.mark.parametrize("d", sorted(tfa.TMA_TILES))
def test_bwd_maps_carry_each_kernels_tile_rows(d):
    q, k, v, _ = _views(1, 40, 4, 2, d)
    do = torch.zeros_like(q)
    g = tfab.tma_maps(q, k, v, do)
    maps = [g[11 * i:11 * i + 11] for i in range(8)]
    (bq, bk), (bkv, bq2) = tfab.DQ_TILES[d], tfab.DKDV_TILES[d]
    assert bq == 128 and bkv == tfab.DKDV_KEYS == 64   # 2 x 64-row wgmma
    for rows in (bq, bk, bkv, bq2):
        assert rows % 16 == 0 and rows <= 256   # k16 steps, TMA's extent
    # the entry point's order: q, dO, k, v for dQ, then for dK/dV
    for m, x, rows in zip(maps, (q, do, k, v) * 2,
                          (bq, bq, bk, bk, bq2, bq2, bkv, bkv)):
        assert m == tfa.tma_geometry(x, rows)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_bwd_emulated_do_boxes_read_the_view_and_never_cross_a_head(
        model, monkeypatch):
    b, s, hq, hkv, d = MODELS[model]
    hkv = min(hkv, 2)              # keep each model's group, up to 3 heads
    hq = hkv * min(MODELS[model][2] // MODELS[model][3], 3)
    _, _, _, _, _, do = _autograd_bwd_args(b, 70, hq, hkv, d, "strided",
                                           monkeypatch)
    # element ids in dO's storage, 1-based so that the zero fill stands
    # apart; the view keeps dO's strides
    ids = torch.arange(1, do.numel() + 1, dtype=torch.int64)
    view = torch.as_strided(ids, do.shape, do.stride())
    storage = ids.numpy()
    want = view.numpy()
    for rows in sorted({tfab.DQ_TILES[d][0], tfab.DKDV_TILES[d][1]}):
        g = tfa.tma_geometry(do, rows)
        for bat in range(b):
            for head in (0, hq - 1):
                for c1 in range(0, 70, rows):               # every q tile
                    for c0 in range(0, d, tfa.TMA_BOX_COLS):
                        box = _tma_box(storage, g, (c0, c1, head, bat))[0, 0]
                        n = min(rows, 70 - c1)
                        np.testing.assert_array_equal(
                            box[:n], want[bat, head, c1:c1 + n,
                                          c0:c0 + tfa.TMA_BOX_COLS])
                        assert not box[n:].any()   # past S: zeros
                        got = box[:n].ravel() - 1  # this head's ids only
                        assert (got // d % hq == head).all()
                        assert (got // (d * hq * 70) == bat).all()


@pytest.mark.parametrize("model", sorted(MODELS))
def test_bwd_group_sum_is_the_sum_of_its_heads_gradients(model):
    # dk, dv per kv head are the sums of the group's per-q-head gradients,
    # as one dK/dV CTA adds them over its group
    b, s, hq, hkv, d = MODELS[model]
    g = hq // hkv
    rng = np.random.default_rng(19)
    q, do = (torch.from_numpy(rng.standard_normal((b, hq, s, d),
                                                  dtype=np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, hkv, s, d),
                                                 dtype=np.float32))
            for _ in range(2))
    o, lse = tref.attention_lse_ref(q, k, v, softcap=50.0)
    dq, dk, dv = tfab.flash_attention_bwd(q, k, v, o, lse, do, softcap=50.0)
    kh, vh = (x.repeat_interleave(g, dim=1) for x in (k, v))
    dqh, dkh, dvh = tfab.flash_attention_bwd(q, kh, vh, o, lse, do,
                                             softcap=50.0)
    torch.testing.assert_close(dq, dqh, rtol=0, atol=0)
    for got, heads in ((dk, dkh), (dv, dvh)):
        torch.testing.assert_close(
            got, heads.view(b, hkv, g, s, d).sum(2), rtol=1e-5, atol=1e-5)


def test_bwd_cpu_calls_take_no_route_and_book_nothing():
    q, k, v, _ = _views(1, 40, 8, 4, 256)
    q, k, v = (torch.randn(x.shape).to(BF16) for x in (q, k, v))
    o, lse = tref.attention_lse_ref(q, k, v, softcap=50.0)
    do = torch.randn(q.shape).to(BF16)
    routes, launches = dict(tfa.BWD_ROUTE_LAUNCHES), dict(tfa.LAUNCHES)
    got = tfab.flash_attention_bwd(q, k, v, o, lse, do, softcap=50.0)
    want = tref.flash_attention_bwd_ref(q, k, v, o, lse, do, softcap=50.0,
                                        scale=256 ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert dict(tfa.BWD_ROUTE_LAUNCHES) == routes
    assert dict(tfa.LAUNCHES) == launches


def test_reset_launches_clears_the_bwd_route_counter():
    tfa.BWD_ROUTE_LAUNCHES["wgmma"] += 2
    tfa.BWD_ROUTE_LAUNCHES["classic"] += 1
    tfa.reset_launches()
    assert dict(tfa.BWD_ROUTE_LAUNCHES) == {"wgmma": 0, "classic": 0}
    assert dict(tfa.ROUTE_LAUNCHES) == {"wgmma": 0, "classic": 0}

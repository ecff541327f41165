"""Port parity: ``repro_torch.core.delayed`` (the bucket exchange),
``repro_torch.core.sharding`` (the owner maps) and
``repro_torch.core.bitarray.sharded_mark_sync`` vs the JAX package.

* ``bin_by_dest`` / ``unbin`` against ``repro.core.delayed`` in one
  process, bit for bit, with the exact ``dropped`` count.
* ``block_owner`` / ``hash_owner`` against the golden values of
  ``tests/test_cluster.py:82-105`` and against ``repro.core.sharding``.
* ``bucket_sync_update`` (with K5's plain version as the owner apply: the
  payload carries each op's local row as int32 bits in one extra float32
  column), ``bucket_sync_access`` and ``sharded_mark_sync`` (K2's plain
  version) over gloo in 2 and 4 ``torch.multiprocessing`` processes, held
  against the reference inside ``jax.shard_map`` on as many fake CPU
  devices (the ``multidev`` fixture, ``impl="ref"``), with a bucket
  capacity that drops nothing and one that drops: the same outputs bit
  for bit (the payloads are small integers, so float32 sums are exact in
  any order) and the same ``dropped``.
"""
import datetime
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.core import delayed as JD
from repro.core import sharding as JS
from repro_torch.core import bitarray as BA
from repro_torch.core import delayed as D
from repro_torch.core import sharding as S
from repro_torch.kernels import ops

WORLD_TIMEOUT_S = 120
N_LOCAL, D_COLS, M_LOCAL, NW_LOCAL = 8, 3, 24, 2
CAPS = (M_LOCAL, 3)                 # one that drops nothing, one that drops


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's CPU thread pool costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- one process

def _bin_inputs(seed, m, nb, p_valid=0.7):
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, nb, m).astype(np.int32)
    valid = rng.random(m) < p_valid
    pay = rng.integers(0, 100, (m, 2)).astype(np.int32)
    return dest, pay, valid


def _oracle_dropped(dest, valid, nb, cap):
    counts = np.bincount(dest[valid & (dest >= 0) & (dest < nb)],
                         minlength=nb)
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("m,nb,cap,p_valid", [
    (64, 4, 5, 0.7), (64, 4, 64, 0.7), (32, 4, 3, 1.0), (16, 4, 2, 0.0),
    (10, 3, 0, 0.5), (40, 1, 7, 0.9)])
def test_bin_by_dest_and_unbin_match_jax(m, nb, cap, p_valid):
    dest, pay, valid = _bin_inputs(m * nb + cap, m, nb, p_valid)
    if m == 32:
        dest[:] = 0                                   # one hot bucket
    got = D.bin_by_dest(torch.from_numpy(dest), torch.from_numpy(pay),
                        torch.from_numpy(valid), nb, cap)
    want = JD.bin_by_dest(jnp.asarray(dest), jnp.asarray(pay),
                          jnp.asarray(valid), nb, cap)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int(got.dropped) == _oracle_dropped(dest, valid, nb, cap)
    assert int(got.valid.sum()) == int(valid.sum()) - int(got.dropped)
    res = got.payload * 2 + 1
    back = D.unbin(res, got.src_idx, m)
    assert np.array_equal(back.numpy(), np.asarray(JD.unbin(
        jnp.asarray(res.numpy()), want.src_idx, m)))


ROWS1 = np.array([[0], [1], [2], [0xFFFFFFFF], [0xDEADBEEF]], np.uint32)
ROWS2 = np.array([[0, 0], [1, 2], [2, 1], [123456789, 987654321]], np.uint32)


def _t(rows):
    return torch.from_numpy(rows.view(np.int32).copy())


def test_owner_maps_golden():
    assert S.hash_owner(_t(ROWS1), 4).tolist() == [2, 2, 3, 2, 1]
    assert S.hash_owner(_t(ROWS1), 7).tolist() == [6, 3, 5, 2, 6]
    assert S.hash_owner(_t(ROWS2), 4).tolist() == [1, 3, 3, 1]
    assert S.hash_owner(_t(ROWS2), 7).tolist() == [3, 6, 1, 2]
    idx = torch.tensor([0, 1, 9, 10, 11, 63, 64, 99])
    assert S.block_owner(idx, 100, 4).tolist() == [0, 0, 0, 0, 0, 2, 2, 3]
    assert S.block_owner(idx, 100, 3).tolist() == [0, 0, 0, 0, 0, 1, 1, 2]


@pytest.mark.parametrize("ns", [1, 2, 3, 4, 7, 8])
def test_owner_maps_match_jax(ns):
    rng = np.random.default_rng(ns)
    rows = rng.integers(0, 1 << 32, (64, 2), dtype=np.uint64).astype(np.uint32)
    got = S.hash_owner(_t(rows), ns)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(),
                          np.asarray(JS.hash_owner(jnp.asarray(rows), ns)))
    idx = rng.integers(0, 1000, 128).astype(np.int32)
    assert np.array_equal(
        S.block_owner(torch.from_numpy(idx), 1000, ns).numpy(),
        np.asarray(JS.block_owner(jnp.asarray(idx), 1000, ns)))


# ------------------------------------------------------ across processes

def _world_inputs(world: int) -> dict:
    """Global inputs of every sharded case; rank r takes the r-th slice of
    each leading axis, as ``shard_map``'s ``P("x")`` does."""
    rng = np.random.default_rng(100 + world)
    m = world * M_LOCAL
    rows = rng.integers(0, world * N_LOCAL, m)
    pay = rng.integers(-8, 9, (m, D_COLS)).astype(np.float32)
    local = (rows % N_LOCAL).astype(np.int32)
    return {
        "table": rng.integers(-50, 50, (world * N_LOCAL, D_COLS)).astype(
            np.float32),
        "u_dest": (rows // N_LOCAL).astype(np.int32),
        # the op's local row rides as int32 bits in one extra column
        "u_pay": np.concatenate([pay, local.view(np.float32)[:, None]], 1),
        "u_valid": rng.random(m) < 0.85,
        "a_dest": rng.integers(0, world, m).astype(np.int32),
        "a_pay": rng.integers(0, 1000, (m, 2)).astype(np.int32),
        "a_valid": rng.random(m) < 0.8,
        "words": rng.integers(0, 1 << 32, world * NW_LOCAL, dtype=np.uint64
                              ).astype(np.uint32),
        "m_idx": rng.integers(-5, world * NW_LOCAL * 16 + 5, m).astype(
            np.int32),
        "m_valid": rng.random(m) < 0.9,
    }


JAX_SIDE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import bitarray as BA
from repro.core import delayed as D
from repro.kernels import ref as R

N_LOCAL, D_COLS = {n_local}, {d_cols}
out = {{}}
for world in {worlds}:
    g = dict(np.load(f"{root}/inputs_{{world}}.npz"))
    mesh = jax.make_mesh((world,), ("x",), devices=jax.devices()[:world],
                         axis_types=(jax.sharding.AxisType.Auto,))
    sm = lambda f, n_in, outs: jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P("x"),) * n_in, out_specs=outs))
    for cap in {caps}:
        def owner_apply(state, flat, valid):
            idx = jax.lax.bitcast_convert_type(flat[:, D_COLS], jnp.int32)
            idx = jnp.where(valid, idx, N_LOCAL)
            return R.bucket_scatter_add_ref(state, idx, flat[:, :D_COLS])

        def upd(table, dest, pay, valid):
            return D.bucket_sync_update(dest, pay, valid, "x", world, cap,
                                        owner_apply, table)
        t, dr = sm(upd, 4, (P("x"), P()))(
            jnp.asarray(g["table"]), jnp.asarray(g["u_dest"]),
            jnp.asarray(g["u_pay"]), jnp.asarray(g["u_valid"]))
        out[f"update_{{world}}_{{cap}}"] = np.asarray(t)
        out[f"update_dropped_{{world}}_{{cap}}"] = np.asarray(dr)

        def acc(dest, pay, valid):
            return D.bucket_sync_access(
                dest, pay, valid, "x", world, cap,
                lambda r, v: jnp.where(v[..., None], r * 3 + 1, 0))
        o, ok, dr = sm(acc, 3, (P("x"), P("x"), P()))(
            jnp.asarray(g["a_dest"]), jnp.asarray(g["a_pay"]),
            jnp.asarray(g["a_valid"]))
        out[f"access_{{world}}_{{cap}}"] = np.asarray(o)
        out[f"access_ok_{{world}}_{{cap}}"] = np.asarray(ok)
        out[f"access_dropped_{{world}}_{{cap}}"] = np.asarray(dr)

        def mark(data, idx, valid):
            return BA.sharded_mark_sync(data, idx, valid, "x", world, cap,
                                        impl="ref")
        w, dr = sm(mark, 3, (P("x"), P()))(
            jnp.asarray(g["words"]), jnp.asarray(g["m_idx"]),
            jnp.asarray(g["m_valid"]))
        out[f"mark_{{world}}_{{cap}}"] = np.asarray(w)
        out[f"mark_dropped_{{world}}_{{cap}}"] = np.asarray(dr)
np.savez(f"{root}/jax_out.npz", **out)
print("jax side ok")
"""


def _torch_rank(rank: int, world: int, root: str) -> None:
    """One rank of the port's side: gloo over a file store, every case on
    this rank's slice, results to ``root/torch_<world>_<rank>.npz``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{root}/store_{world}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
    try:
        g = dict(np.load(f"{root}/inputs_{world}.npz"))
        mine = {k: torch.from_numpy(np.array_split(v, world)[rank])
                for k, v in g.items()}
        out = {}
        for cap in CAPS:
            def owner_apply(state, flat, valid):
                idx = flat[:, D_COLS].contiguous().view(torch.int32)
                idx = torch.where(valid, idx, N_LOCAL)
                return ops.bucket_scatter_add(state, idx, flat[:, :D_COLS])
            t, dr = D.bucket_sync_update(
                mine["u_dest"], mine["u_pay"], mine["u_valid"], None, world,
                cap, owner_apply, mine["table"])
            out[f"update_{cap}"], out[f"update_dropped_{cap}"] = t, dr
            o, ok, dr = D.bucket_sync_access(
                mine["a_dest"], mine["a_pay"], mine["a_valid"], None, world,
                cap, lambda r, v: torch.where(v[..., None], r * 3 + 1, 0))
            out[f"access_{cap}"], out[f"access_ok_{cap}"] = o, ok
            out[f"access_dropped_{cap}"] = dr
            w, dr = BA.sharded_mark_sync(
                mine["words"].view(torch.int32), mine["m_idx"],
                mine["m_valid"], None, world, cap)
            out[f"mark_{cap}"], out[f"mark_dropped_{cap}"] = w, dr
        np.savez(f"{root}/torch_{world}_{rank}.npz",
                 **{k: v.numpy() for k, v in out.items()})
    finally:
        dist.destroy_process_group()


def _run_world(world: int, root: str) -> None:
    ctx = mp.start_processes(_torch_rank, args=(world, root), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"gloo world of {world} did not finish in "
                        f"{WORLD_TIMEOUT_S} s")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory, multidev_module):
    root = tmp_path_factory.mktemp("delayed")
    for world in (2, 4):
        np.savez(root / f"inputs_{world}.npz", **_world_inputs(world))
    code = JAX_SIDE.format(n_local=N_LOCAL, d_cols=D_COLS, worlds=(2, 4),
                           caps=CAPS, root=root)
    multidev_module(code, n_devices=4)
    return root, dict(np.load(root / "jax_out.npz"))


@pytest.fixture(scope="module")
def multidev_module():
    """``tests/conftest.py``'s ``multidev``, once for the module."""
    from conftest import run_multidev
    return run_multidev


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_syncs_match_shard_map(world, jax_side):
    root, want = jax_side
    _run_world(world, str(root))
    got = [dict(np.load(root / f"torch_{world}_{r}.npz"))
           for r in range(world)]
    for cap in CAPS:
        for name in ("update", "access", "access_ok", "mark"):
            mine = np.concatenate([g[f"{name}_{cap}"] for g in got])
            theirs = want[f"{name}_{world}_{cap}"]
            if name == "mark":
                mine = mine.view(np.uint32)
            assert mine.shape == theirs.shape, (name, cap)
            assert np.array_equal(mine, theirs), (name, world, cap)
        for name in ("update_dropped", "access_dropped", "mark_dropped"):
            drops = {int(g[f"{name}_{cap}"]) for g in got}
            assert drops == {int(want[f"{name}_{world}_{cap}"])}, (name, cap)
    assert int(want[f"update_dropped_{world}_{CAPS[0]}"]) == 0
    assert int(want[f"mark_dropped_{world}_{CAPS[1]}"]) > 0   # it dropped

"""Pancake sorting via the sorted-list BFS, the paper's first BFS engine:
on the GPU (Tier J, the default ``--tier j``) or on disk (``--tier disk``).

Port of ``examples/pancake_bfs.py``: a stack of n pancakes is a row of
4-bit codes.  On Tier J ``core.constructs.breadth_first_search`` keeps the
frontier and the visited set as lists of such rows on the device; a level
expands the frontier through all n − 1 prefix flips, then takes one
lexsort and one append scatter.  On Tier D ``core.disk.
breadth_first_search`` keeps them as sorted runs of chunk files and
expands them on the host (``HostMoves``), as the reference does.

Encoding: ``words(n) = ceil(n / 8)`` 32-bit words a row, 8 nibbles a
word; position i is nibble i % 8 of word i // 8.  At n ≤ 8 that is the
reference's single uint32 word, bit for bit; the reference's one word
overflows at n ≥ 9.

  PYTHONPATH=src python -m repro_torch.apps.pancake_bfs --n 11
  PYTHONPATH=src python -m repro_torch.apps.pancake_bfs --n 11 --unfused
  PYTHONPATH=src python -m repro_torch.apps.pancake_bfs --n 8 --device cpu \
      --check
  PYTHONPATH=src python -m repro_torch.apps.pancake_bfs --n 10 --tier disk
  PYTHONPATH=src python -m repro_torch.apps.pancake_bfs --n 10 --tier disk \
      --shards 4 [--transport tcp] [--exchange pipelined] [--trace run.jsonl]

``--shards N`` runs the disk engine over N shard workers (``--shard-mode
spawn|inline``), each sorting only the states that hash to it, with the
rows for other shards on the bucket wire (``--transport fs|tcp|loopback``,
``--exchange barrier|pipelined``); ``--trace PATH`` writes the run's JSONL
trace and prints its per-level report.

n = 11 fits one 80 GB card (the widest level sorts 172M rows).  n = 12
would sort 2.3e9 rows, past one card and the int32 run ids: the implicit
engine (``apps.pancake_bits``) runs it.  ``--check`` holds the level sizes
against that engine at the same n.  Known diameters (OEIS A058986):
4→4 5→5 6→7 7→8 8→9 9→10 10→11 11→13 12→14.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time

import numpy as np
import torch

from .. import device as _device
from ..core import constructs as C
from ..core import types as T
from ..core.disk import bfs as DB
from ..core.disk import trace
from ..core.disk.config import ClusterConfig
from . import pancake_bits as P

NIBBLES = 8        # 4-bit codes a 32-bit word holds


def words(n: int) -> int:
    return -(-n // NIBBLES)


def start_code(n: int) -> np.ndarray:
    """(words(n),) uint32: the sorted stack, position i holding i."""
    code = [0] * words(n)
    for i in range(n):
        code[i // NIBBLES] |= i << (4 * (i % NIBBLES))
    return np.asarray(code, np.uint32)


def _shifts(n: int, dev) -> torch.Tensor:
    return 4 * (torch.arange(n, device=dev) % NIBBLES)


def unpack(rows: torch.Tensor, n: int) -> torch.Tensor:
    """(m, words) int32 rows → (m, n) int64 positions."""
    word = torch.arange(n, device=rows.device) // NIBBLES
    return (rows[:, word].to(torch.int64) >> _shifts(n, rows.device)) & 0xF


def pack(perms: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) int64 positions → (..., words) int32 rows."""
    vals = perms << _shifts(n, perms.device)
    return torch.stack([T.to_int32_bits(vals[..., j:j + NIBBLES].sum(-1))
                        for j in range(0, n, NIBBLES)], dim=-1)


class Moves:
    """A batched generator for the sorted BFS: row k of ``table`` lists,
    for each position, the position its code comes from after move k.
    Maps (m, words) int32 rows to ((m, fanout, words) int32 rows,
    (m, fanout) bool), every move valid."""

    def __init__(self, n: int, table):
        self.n = n
        self.table = torch.tensor(table, dtype=torch.int64)
        self.fanout = self.table.shape[0]

    def __call__(self, rows: torch.Tensor):
        perms = unpack(rows, self.n)
        moved = perms[:, self.table.to(rows.device)]      # (m, fanout, n)
        ok = torch.ones(moved.shape[:2], dtype=torch.bool, device=rows.device)
        return pack(moved, self.n), ok


class HostMoves:
    """The host generator of the disk engine over the same rows and
    moves: maps (m, words) uint32 rows to (m·fanout, words) uint32 rows,
    move-major (every row's first move, then every row's second, ...), as
    the reference's generators emit them — at n ≤ 8 its rows bit for
    bit."""

    def __init__(self, n: int, table):
        self.n = n
        self.table = np.asarray(table, np.int64)
        self.fanout = self.table.shape[0]

    def __call__(self, chunk: np.ndarray) -> np.ndarray:
        n, w = self.n, words(self.n)
        rows = np.asarray(chunk, np.uint32).reshape(-1, w)
        pos = np.arange(n)
        shift = (4 * (pos % NIBBLES)).astype(np.uint32)
        perms = (rows[:, pos // NIBBLES] >> shift) & np.uint32(0xF)
        moved = perms[:, self.table].transpose(1, 0, 2)    # (fanout, m, n)
        out = np.zeros(moved.shape[:2] + (w,), np.uint32)
        for i in range(n):
            out[..., i // NIBBLES] |= moved[..., i] << shift[i]
        return out.reshape(-1, w)


def prefix_flips(n: int) -> Moves:
    """The n − 1 prefix reversals of 2..n pancakes."""
    return Moves(n, P.prefix_flip_table(n))


def search(n: int, moves: Moves, fused: bool = True, device=None):
    """The full BFS from the sorted stack at the reference's capacities
    (n! + 8 rows for the visited list and each level).  Returns
    (BFSResult, wall seconds, peak device bytes or None on the CPU)."""
    dev = _device.resolve(device)
    total = math.factorial(n)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = C.breadth_first_search(start_code(n)[None], moves,
                                 fanout=moves.fanout, width=words(n),
                                 all_capacity=total + 8,
                                 level_capacity=total + 8, fused=fused,
                                 device=dev)
    peak = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    return res, time.perf_counter() - t0, peak


def disk_search(n: int, gen: HostMoves, chunk_rows: int = 1 << 14,
                fused: bool = True, compress: bool = False, cluster=None,
                trace_path=None, example: str = "pancake_bfs"):
    """The disk engine's BFS from the sorted stack, in a temporary
    directory, on the host, sharded by ``cluster`` (a ``ClusterConfig``)
    when given; ``trace_path`` writes the run's JSONL trace there and
    prints its report.  Returns (level_sizes, wall seconds)."""
    if trace_path:
        # Before the runtime spawns: workers read $ROOMY_TRACE at startup.
        trace.start(trace_path, meta={
            "example": example, "n": n, "tier": "disk",
            "nshards": cluster.nshards if cluster is not None else 1})
    try:
        with tempfile.TemporaryDirectory() as wd:
            t0 = time.perf_counter()
            sizes, all_ = DB.breadth_first_search(
                wd, start_code(n)[None], gen, width=words(n),
                chunk_rows=chunk_rows, fused=fused, compress=compress,
                cluster=cluster)
            secs = time.perf_counter() - t0
            all_.destroy()
    finally:
        if trace_path:
            trace.report(trace.stop())
    return sizes, secs


def run_disk(n: int, chunk_rows: int = 1 << 14, fused: bool = True,
             compress: bool = False, shards: int = 1,
             shard_mode: str = "spawn", transport: str = "fs",
             exchange=None, trace_path=None):
    """Full pancake BFS for n on disk (Tier D, the host), over ``shards``
    shard workers when it is above 1; prints the level sizes, the
    diameter and states/s.  Returns (level_sizes, wall seconds)."""
    if not 3 <= n <= 12:
        raise ValueError(f"n={n}: the 4-bit encoding takes 3 <= n <= 12")
    total = math.factorial(n)
    print(f"pancake n={n}: {total} states, sorted-list BFS on disk "
          f"({'fused' if fused else 'unfused'}), {words(n)} word(s) a row"
          + (f", shards={shards}" if shards > 1 else ""))
    sizes, secs = disk_search(
        n, HostMoves(n, P.prefix_flip_table(n)), chunk_rows, fused,
        compress, ClusterConfig(nshards=shards, mode=shard_mode,
                                transport=transport, exchange=exchange),
        trace_path)
    if sum(sizes) != total:
        raise SystemExit("did not enumerate the full graph!")
    print("level sizes:", sizes)
    print(f"diameter (max flips to sort): {len(sizes) - 1}")
    print(f"{total / secs:.0f} states/s ({secs:.3f}s)")
    want = P.DIAMETERS.get(n)
    if want is not None and len(sizes) - 1 != want:
        raise SystemExit(f"diameter {len(sizes) - 1} != known {want}")
    return sizes, secs


def report(res, total: int, secs: float, peak) -> None:
    print("level sizes:", res.level_sizes)
    print(f"{total / secs:.0f} states/s ({secs:.3f}s), peak device memory "
          + (f"{peak} bytes" if peak is not None else "not measured (cpu)"))


def run(n: int, fused: bool = True, device=None):
    """Full pancake BFS for n; prints the level sizes, the diameter,
    states/s and peak device memory.  Returns (level_sizes, BFSResult,
    wall seconds)."""
    if not 3 <= n <= 12:
        raise ValueError(f"n={n}: the 4-bit encoding takes 3 <= n <= 12")
    total = math.factorial(n)
    print(f"pancake n={n}: {total} states, sorted-list BFS "
          f"({'fused' if fused else 'unfused'}), {words(n)} word(s) a row")
    res, secs, peak = search(n, prefix_flips(n), fused, device)
    sizes = res.level_sizes
    if sum(sizes) != total or int(res.all.count) != total:
        raise SystemExit("did not enumerate the full graph!")
    report(res, total, secs, peak)
    print(f"diameter (max flips to sort): {len(sizes) - 1}")
    want = P.DIAMETERS.get(n)
    if want is not None and len(sizes) - 1 != want:
        raise SystemExit(f"diameter {len(sizes) - 1} != known {want}")
    return sizes, res, secs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=11)
    ap.add_argument("--tier", choices=("j", "disk"), default="j",
                    help="j: the device engine (default); disk: sorted "
                         "runs of chunk files, on the host")
    ap.add_argument("--chunk-rows", type=int, default=1 << 14,
                    help="rows a chunk file holds (disk tier)")
    ap.add_argument("--compress", action="store_true",
                    help="store sorted runs varint-delta coded (disk tier)")
    ap.add_argument("--unfused", action="store_true",
                    help="add, removeDupes, removeAll, addAll (2 lexsorts "
                         "and 2 scatters a level) instead of the fused "
                         "level (1 and 1)")
    ap.add_argument("--shards", type=int, default=1,
                    help="run the disk tier over N shard workers")
    ap.add_argument("--shard-mode", choices=("spawn", "inline"),
                    default="spawn",
                    help="shard workers as processes (default) or in this "
                         "process")
    ap.add_argument("--transport", choices=("fs", "tcp", "loopback"),
                    default="fs",
                    help="bucket wire between shards: shared files "
                         "(default), TCP sockets, or the in-process "
                         "loopback store (inline mode only)")
    ap.add_argument("--exchange", choices=("barrier", "pipelined"),
                    default=None,
                    help="exchange discipline: two-phase barrier (default) "
                         "or overlapped produce/apply")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a JSONL trace of the disk tier's run to "
                         "PATH and print its per-level report")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    ap.add_argument("--check", action="store_true",
                    help="hold the level sizes against the implicit 2-bit "
                         "engine (apps.pancake_bits, on --device) at the "
                         "same n")
    args = ap.parse_args(argv)
    if args.compress and (args.tier != "disk" or args.unfused):
        ap.error("--compress is the fused disk tier's")
    if args.tier != "disk" and (args.shards != 1 or args.transport != "fs"
                                or args.exchange or args.trace):
        ap.error("--shards, --transport, --exchange and --trace are the "
                 "disk tier's")
    if args.unfused and (args.shards != 1 or args.transport != "fs"
                         or args.exchange):
        ap.error("--unfused is the one-process pass; it cannot shard")
    if args.tier == "disk":
        sizes, _ = run_disk(args.n, args.chunk_rows, not args.unfused,
                            args.compress, args.shards, args.shard_mode,
                            args.transport, args.exchange, args.trace)
    else:
        sizes, _, _ = run(args.n, fused=not args.unfused, device=args.device)
    if args.check:
        want, _, _ = P.run(args.n, device=args.device)
        if sizes != want:
            raise SystemExit(f"check: level sizes {sizes} != the implicit "
                             f"engine's {want}")
        print("check: level sizes match the implicit engine's")


if __name__ == "__main__":
    main()

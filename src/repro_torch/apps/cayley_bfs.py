"""Cayley-graph BFS: S_n under adjacent transpositions (the bubble-sort
graph), with the sorted-list engine on the GPU (Tier J, the default
``--tier j``) or on disk (``--tier disk``, the host).

Port of ``examples/cayley_bfs.py``.  Ground truth
is exact: the distance of a permutation from the identity is its
inversion count, so

  level sizes  == Mahonian numbers T(n, k)   (# permutations, k inversions)
  diameter     == n(n-1)/2

States are rows of 4-bit codes, as in ``apps.pancake_bfs`` (ceil(n / 8)
words a row; the reference's one uint32 word at n ≤ 8); the disk engine
expands them on the host with ``pancake_bfs.HostMoves``.

  PYTHONPATH=src python -m repro_torch.apps.cayley_bfs --n 11
  PYTHONPATH=src python -m repro_torch.apps.cayley_bfs --n 6 --device cpu
  PYTHONPATH=src python -m repro_torch.apps.cayley_bfs --n 8 --tier disk
  PYTHONPATH=src python -m repro_torch.apps.cayley_bfs --n 8 --tier disk \
      --shards 4 --trace run.jsonl

``--shards N`` runs the disk engine over N spawned shard workers;
``--trace PATH`` writes the run's JSONL trace and prints its per-level
report.
"""
from __future__ import annotations

import argparse
import math

from ..core.disk.config import ClusterConfig
from .pancake_bfs import HostMoves, Moves, disk_search, report, search


def mahonian(n: int) -> list:
    """T(n, k) for k = 0..n(n-1)/2 via the classic DP."""
    t = [1]
    for m in range(2, n + 1):
        new = [0] * (len(t) + m - 1)
        for k, v in enumerate(t):
            for j in range(m):
                new[k + j] += v
        t = new
    return t


def adjacent_swaps(n: int) -> Moves:
    """The n − 1 transpositions of positions i and i + 1."""
    table = []
    for i in range(n - 1):
        idx = list(range(n))
        idx[i], idx[i + 1] = idx[i + 1], idx[i]
        table.append(idx)
    return Moves(n, table)


def run(n: int, device=None, tier: str = "j", shards: int = 1,
        shard_mode: str = "spawn", trace_path=None):
    """Full BFS of the bubble-sort graph of S_n on ``tier`` ("j": the
    device; "disk": chunk files of 8192 rows, on the host, over
    ``shards`` shard workers in ``shard_mode``, with a JSONL trace at
    ``trace_path`` when given); holds the level sizes to the Mahonian
    numbers and the diameter to n(n-1)/2, and prints states/s.  Returns
    (level_sizes, BFSResult or None, wall seconds)."""
    if not 3 <= n <= 12:
        raise ValueError(f"n={n}: the 4-bit encoding takes 3 <= n <= 12")
    total = math.factorial(n)
    print(f"S_{n} bubble-sort Cayley graph: {total} vertices, diameter "
          f"should be {n * (n - 1) // 2}")
    if tier == "disk":
        moves = adjacent_swaps(n)
        res = None
        sizes, secs = disk_search(
            n, HostMoves(n, moves.table.tolist()), chunk_rows=1 << 13,
            cluster=ClusterConfig(nshards=shards, mode=shard_mode),
            trace_path=trace_path, example="cayley_bfs")
        print("level sizes:", sizes)
        print(f"{total / secs:.0f} states/s ({secs:.3f}s) on disk")
    else:
        res, secs, peak = search(n, adjacent_swaps(n), device=device)
        sizes = res.level_sizes
        report(res, total, secs, peak)
    want = mahonian(n)
    if sizes != want:
        raise SystemExit(f"Mahonian mismatch!\n got {sizes}\nwant {want}")
    if len(sizes) - 1 != n * (n - 1) // 2:
        raise SystemExit(f"diameter {len(sizes) - 1} != n(n-1)/2")
    print(f"✓ level sizes == Mahonian numbers T({n},k); "
          f"diameter {len(sizes) - 1} == n(n-1)/2")
    return sizes, res, secs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=11)
    ap.add_argument("--tier", choices=("j", "disk"), default="j",
                    help="j: the device engine (default); disk: sorted "
                         "runs of chunk files, on the host")
    ap.add_argument("--shards", type=int, default=1,
                    help="run the disk tier over N shard workers")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a JSONL trace of the disk tier's run to "
                         "PATH and print its per-level report")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    if args.tier != "disk" and (args.shards != 1 or args.trace):
        ap.error("--shards and --trace are the disk tier's")
    run(args.n, device=args.device, tier=args.tier, shards=args.shards,
        trace_path=args.trace)


if __name__ == "__main__":
    main()
